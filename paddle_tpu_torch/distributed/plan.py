"""Parallelism plans: one object from the planner to the train step (the
port of ``paddle_tpu/distributed/plan.py:49-440``).

A ``Plan`` names the axis degrees (``dp/pp/sharding/sp/mp``), the
pipeline schedule and microbatch count, whether the gradient reduction
overlaps the backward, and (optionally) the per-parameter partition
specs in the reference's portable JSON form.  ``Plan(...)`` by hand,
``Plan.from_report`` from a ``tools/pod_report.py`` report or the spec
its ``--plan-out`` writes, ``Plan.load``/``from_spec`` from a spec; out
comes ``plan.train_step(cfg)``, ``models.llama.build_train_step`` on the
plan's topology over the ranks of the process group.

Not ported: ``compile``'s pjit/shard_map selection and the SPMD checker
(``verify_callable``, ``verify=True``) have no counterpart over
``torch.distributed`` and raise (ROADMAP A5); ``run_train_loop``'s
in-process elastic resize needs a process group that shrinks within a
world and raises when a resize is asked for (ROADMAP A item 4).  A
resize across processes runs today: the gang runtime's final save, the
elastic launcher's relaunch at the new size, and
``reshard.restore_resharded`` (``distributed/gang.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterable, List, Optional

from ..profiler import exporter as _exporter
from ..profiler import trace as _trace

__all__ = ["Plan", "PlanError", "SCHEDULES"]

SCHEDULES = ("none", "gpipe", "1f1b", "interleaved")

AXES = ("dp", "pp", "sharding", "sp", "mp")

_NO_SPMD = ("the SPMD compile selection and checker (pjit / shard_map, "
            "jaxpr lint) have no counterpart over torch.distributed "
            "(ROADMAP A5: analysis)")


class PlanError(Exception):
    """An invalid plan, or one the process group cannot run."""


def _wrap_step_tracing(plan: "Plan", step_fn: Callable) -> Callable:
    """Per-rank train-step spans for the flight recorder: each call
    emits a shared-name barrier event (what ``trace.merge_ranks`` aligns
    rank clocks on) and runs in a ``train/step`` span; the first traced
    step of a pipelined plan also records the 1F1B schedule
    (``trace.record_pipeline_schedule``), from which
    ``tools/trace_report.py`` scores the measured overlap with the
    simulator's own events.  Tracing off: one dict lookup a step."""
    counter = {"n": 0}

    def traced(params, opt_state, batch):
        if not _trace.enabled():
            return step_fn(params, opt_state, batch)
        n = counter["n"]
        counter["n"] += 1
        if n == 0 and plan.pp > 1 and plan.schedule != "none":
            _trace.record_pipeline_schedule(
                plan.pp, plan.n_microbatches or plan.pp,
                overlap=plan.overlap, step=n)
        _trace.barrier(f"train/step{n}")
        with _trace.span("train/step", step=n, dp=plan.dp, pp=plan.pp,
                         schedule=plan.schedule, overlap=plan.overlap):
            return step_fn(params, opt_state, batch)

    for attr in ("topology", "shard_batch", "overlap", "schedule",
                 "n_microbatches", "virtual_pp", "plan", "plan_topology"):
        if hasattr(step_fn, attr):
            setattr(traced, attr, getattr(step_fn, attr))
    return traced


@dataclasses.dataclass
class Plan:
    """Executable parallelism plan over the 5-axis hybrid topology.

    ``param_specs``, when present, maps '/'-joined parameter paths to
    the reference's ``reshard.spec_to_json`` partition specs; the port
    carries them through its spec round trip."""

    dp: int = 1
    pp: int = 1
    sharding: int = 1
    sp: int = 1
    mp: int = 1
    schedule: str = "none"
    n_microbatches: Optional[int] = None
    overlap: bool = False
    param_specs: Optional[Dict[str, List[Optional[List[str]]]]] = None

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise PlanError(
                f"unknown schedule {self.schedule!r}; expected one of "
                f"{SCHEDULES}")
        for a in AXES:
            d = getattr(self, a)
            if not isinstance(d, int) or d < 1:
                raise PlanError(f"axis degree {a}={d!r} must be a "
                                "positive int")
        if self.schedule != "none" and self.pp == 1:
            raise PlanError(
                f"schedule={self.schedule!r} needs pp > 1 (got pp=1); "
                "use schedule='none' for non-pipelined plans")

    # -- topology -----------------------------------------------------------
    @property
    def world_size(self) -> int:
        return self.dp * self.pp * self.sharding * self.sp * self.mp

    @property
    def dims(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    def topology(self):
        """The ``HybridTopology`` of this plan's degrees over the ranks of
        the process group (a world of one without one), which must have
        exactly ``world_size`` ranks."""
        import torch.distributed as dist
        from .mesh import HybridTopology
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.world_size:
            raise PlanError(
                f"plan needs {self.world_size} ranks "
                f"({'x'.join(str(d) for d in self.dims.values())}), the "
                f"process group has {world}")
        return HybridTopology(dp=self.dp, pp=self.pp,
                              sharding=self.sharding, sp=self.sp,
                              mp=self.mp)

    def compile(self, fn: Callable, **kwargs):
        raise NotImplementedError(f"Plan.compile: {_NO_SPMD}")

    def verify_callable(self, fn, *args, **kwargs):
        raise NotImplementedError(f"Plan.verify_callable: {_NO_SPMD}")

    # -- the llama training step --------------------------------------------
    def train_step(self, cfg, *, optimizer=None, zero=True,
                   verify: Optional[bool] = None, device=None):
        """``(step_fn, init_fn)`` for this plan: ``models.llama
        .build_train_step`` on the plan's topology with its schedule,
        microbatch count and overlap flag, on ``device`` (the card
        unless the caller names another).  ``verify=True`` raises
        (ROADMAP A5)."""
        if verify:
            raise NotImplementedError(f"Plan.train_step(verify=True): "
                                      f"{_NO_SPMD}")
        from ..models.llama import build_train_step
        topo = self.topology()
        use_pp = self.pp > 1 and self.schedule != "none"
        step_fn, init_fn = build_train_step(
            cfg, topo, optimizer=optimizer, use_pp=use_pp,
            n_microbatches=self.n_microbatches or (self.pp if use_pp
                                                   else None),
            zero=zero, schedule=self.schedule if use_pp else "gpipe",
            overlap=self.overlap, device=device)
        step_fn.plan = self
        step_fn.plan_topology = topo
        return _wrap_step_tracing(self, step_fn), init_fn

    # -- spec round-trip ----------------------------------------------------
    def to_spec(self) -> Dict[str, Any]:
        spec = {"axes": self.dims, "schedule": self.schedule,
                "n_microbatches": self.n_microbatches,
                "overlap": self.overlap}
        if self.param_specs is not None:
            spec["param_specs"] = self.param_specs
        return spec

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "Plan":
        axes = dict(spec.get("axes", {}))
        kw = {a: int(axes.get(a, 1)) for a in AXES}
        return cls(schedule=spec.get("schedule", "none"),
                   n_microbatches=spec.get("n_microbatches"),
                   overlap=bool(spec.get("overlap", False)),
                   param_specs=spec.get("param_specs"), **kw)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_spec(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as f:
            return cls.from_spec(json.load(f))

    @classmethod
    def from_report(cls, report) -> "Plan":
        """A Plan from a pod_report: the report dict, a path to its
        JSON, a ``--plan-out`` spec dict, or a path to one.  The
        planner's winning degrees become the plan's axes; ``pp > 1``
        selects the 1F1B schedule with the report's microbatch count."""
        if isinstance(report, (str, os.PathLike)):
            with open(report) as f:
                report = json.load(f)
        if "axes" in report:  # already an executable plan spec
            return cls.from_spec(report)
        topo = report.get("topology")
        if topo is None:
            raise PlanError("report has no 'topology' section (and is "
                            "not a plan spec)")
        kw = {a: int(topo.get(a, 1)) for a in AXES}
        pp = kw["pp"]
        return cls(schedule="1f1b" if pp > 1 else "none",
                   n_microbatches=int(topo.get("n_microbatches", pp))
                   if pp > 1 else None,
                   overlap=True, **kw)

    # -- elasticity ---------------------------------------------------------
    def for_world_size(self, n: int) -> "Plan":
        """Refit the plan to ``n`` ranks: keep the model axes
        (pp/sharding/sp/mp) and refit dp when they divide ``n``; else
        collapse to pure data parallelism."""
        model = self.pp * self.sharding * self.sp * self.mp
        if n >= model and n % model == 0:
            return dataclasses.replace(self, dp=n // model)
        return dataclasses.replace(
            self, dp=n, pp=1, sharding=1, sp=1, mp=1,
            schedule="none", n_microbatches=None)

    def run_train_loop(self, cfg, batches: Iterable[Dict[str, Any]], *,
                       optimizer=None, seed: int = 0, params=None,
                       job_id: str = "plan",
                       scale_store=None,
                       verify: Optional[bool] = None,
                       on_step: Optional[Callable] = None, device=None):
        """The plan-driven training loop, without elastic resize.

        Every rank iterates the same global batches and trains on its
        rows (``step_fn.shard_batch``).  Before each step the loop polls
        ``scale_store`` for ``fleet.elastic.request_scale``'s key of
        ``job_id``: a world size other than the plan's raises (the
        in-process resize: ROADMAP A item 4).  Returns ``{"losses",
        "world_sizes", "resizes"}``, one entry a step (``resizes`` stays
        empty).  ``on_step(step_count, params, opt_state)`` fires after
        every step.  The params are drawn from ``seed``, or start from
        ``params`` (full params, numpy arrays or tensors)."""
        from ..models.llama import shard_params
        from .fleet.elastic import _scale_key
        step_fn, init_fn = self.train_step(cfg, optimizer=optimizer,
                                           verify=verify, device=device)
        topo = step_fn.plan_topology
        if params is None:
            params, opt_state = init_fn(seed)
        else:
            params, opt_state = init_fn(params=shard_params(
                cfg, params, topo, device=device,
                virtual_pp=step_fn.virtual_pp))

        def _poll_scale():
            if scale_store is None:
                return None
            raw = scale_store.get(_scale_key(job_id))
            if raw is None:
                return None
            return int(raw.decode() if isinstance(raw, bytes) else raw)

        history = {"losses": [], "world_sizes": [], "resizes": []}
        status = {"job_id": job_id, "step": 0, "loss": None,
                  "world_size": self.world_size, "done": False}
        _exporter.maybe_serve("train", lambda: dict(status))
        for batch in batches:
            want = _poll_scale()
            if want is not None and want != self.world_size:
                raise NotImplementedError(
                    f"resize {self.world_size} -> {want} requested: the "
                    f"in-process elastic resize (a process group that "
                    f"shrinks within a world) is not ported yet (ROADMAP "
                    f"A item 4); relaunch the gang at the new size through "
                    f"the elastic launcher and reshard.restore_resharded")
            params, opt_state, m = step_fn(params, opt_state,
                                           step_fn.shard_batch(batch))
            history["losses"].append(float(m["loss"]))
            history["world_sizes"].append(self.world_size)
            if on_step is not None:
                on_step(len(history["losses"]), params, opt_state)
            status.update(step=len(history["losses"]),
                          loss=history["losses"][-1])
        status["done"] = True
        return history
