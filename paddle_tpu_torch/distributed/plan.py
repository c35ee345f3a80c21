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

``plan.run_train_loop`` drives the step over an iterable of global
batches and resizes in process when ``fleet.elastic.request_scale``
asks for fewer ranks: the state goes through a checkpoint, the plan is
refitted (``for_world_size``), the step rebuilt over the first ranks of
the world and the state restored resharded; the ranks past the new size
leave the loop.  A resize across processes (the gang runtime's final
save and the elastic launcher's relaunch) is ``distributed/gang.py``'s.

Not ported: ``compile``'s pjit/shard_map selection and the SPMD checker
(``verify_callable``, ``verify=True``) have no counterpart over
``torch.distributed`` and raise (ROADMAP A5).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from ..profiler import exporter as _exporter
from ..profiler import trace as _trace
from ..profiler import xmem as _xmem

__all__ = ["Plan", "PlanError", "SCHEDULES"]

SCHEDULES = ("none", "gpipe", "1f1b", "interleaved")

AXES = ("dp", "pp", "sharding", "sp", "mp")

_NO_SPMD = ("the SPMD compile selection and checker (pjit / shard_map, "
            "jaxpr lint) have no counterpart over torch.distributed "
            "(ROADMAP A5: analysis)")


class PlanError(Exception):
    """An invalid plan, or one the process group cannot run."""


def _batch_sig(batch) -> tuple:
    return tuple(sorted((k, tuple(getattr(v, "shape", ())))
                        for k, v in batch.items()))


def _wrap_step_tracing(plan: "Plan", step_fn: Callable) -> Callable:
    """Per-rank train-step spans for the flight recorder: each call
    emits a shared-name barrier event (what ``trace.merge_ranks`` aligns
    rank clocks on) and runs in a ``train/step`` span; the first traced
    step of a pipelined plan also records the 1F1B schedule
    (``trace.record_pipeline_schedule``), from which
    ``tools/trace_report.py`` scores the measured overlap with the
    simulator's own events.  With FLAGS_tpu_xmem on (``profiler.xmem``)
    the first call of each batch shape is captured, as the reference
    captures each new signature's executable.  Both off: two dict
    lookups a step."""
    counter = {"n": 0}
    captured = set()

    def run(params, opt_state, batch):
        if _xmem.capturing():
            sig = _batch_sig(batch)
            if sig not in captured:
                captured.add(sig)
                return _xmem.capture("plan", "train_step", step_fn, params,
                                     opt_state, batch, sig=sig)[0]
        return step_fn(params, opt_state, batch)

    def traced(params, opt_state, batch):
        if not _trace.enabled():
            return run(params, opt_state, batch)
        n = counter["n"]
        counter["n"] += 1
        if n == 0 and plan.pp > 1 and plan.schedule != "none":
            _trace.record_pipeline_schedule(
                plan.pp, plan.n_microbatches or plan.pp,
                overlap=plan.overlap, step=n)
        _trace.barrier(f"train/step{n}")
        with _trace.span("train/step", step=n, dp=plan.dp, pp=plan.pp,
                         schedule=plan.schedule, overlap=plan.overlap):
            return run(params, opt_state, batch)

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

    def topology(self, ranks: Optional[int] = None):
        """The ``HybridTopology`` of this plan's degrees over the ranks of
        the process group (a world of one without one), which must have
        exactly ``world_size`` ranks; or, with ``ranks``, over the first
        ``ranks`` of them (its members call it: they alone make its
        groups)."""
        import torch.distributed as dist
        from .mesh import HybridTopology
        world = dist.get_world_size() if dist.is_initialized() else 1
        span = world if ranks is None else int(ranks)
        if span != self.world_size or span > world:
            raise PlanError(
                f"plan needs {self.world_size} ranks "
                f"({'x'.join(str(d) for d in self.dims.values())}), the "
                f"process group has {world}"
                + (f" and the topology spans {span}" if ranks else ""))
        return HybridTopology(dp=self.dp, pp=self.pp,
                              sharding=self.sharding, sp=self.sp,
                              mp=self.mp, ranks=ranks)

    def compile(self, fn: Callable, **kwargs):
        raise NotImplementedError(f"Plan.compile: {_NO_SPMD}")

    def verify_callable(self, fn, *args, **kwargs):
        raise NotImplementedError(f"Plan.verify_callable: {_NO_SPMD}")

    # -- the llama training step --------------------------------------------
    def train_step(self, cfg, *, optimizer=None, zero=True,
                   verify: Optional[bool] = None, device=None,
                   ranks: Optional[int] = None):
        """``(step_fn, init_fn)`` for this plan: ``models.llama
        .build_train_step`` on the plan's topology (over the first
        ``ranks`` ranks of the world, when given) with its schedule,
        microbatch count and overlap flag, on ``device`` (the card
        unless the caller names another).  ``verify=True`` raises
        (ROADMAP A5)."""
        if verify:
            raise NotImplementedError(f"Plan.train_step(verify=True): "
                                      f"{_NO_SPMD}")
        from ..models.llama import build_train_step
        topo = self.topology(ranks)
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
                       job_id: str = "plan", scale_store=None,
                       ckpt_root: Optional[str] = None,
                       verify: Optional[bool] = None,
                       on_step: Optional[Callable] = None, device=None):
        """The plan-driven training loop with in-process elastic resize.

        Every rank iterates the same global batches and trains on its
        rows (``step_fn.shard_batch``).  Before each step rank 0 reads
        ``fleet.elastic.request_scale``'s key of ``job_id`` from
        ``scale_store`` (every rank passes the same store, or none) and
        broadcasts it over the plan's ranks, so every rank sees a request
        at the same step, however it landed between their reads.  On a
        world size below the plan's (a larger one is ignored, as the
        reference ignores one above its device count: the ranks that
        left a shrink do not come back):
        the state is gathered whole and saved through ``ckpt_root``
        (params and optimizer state, ``pickle`` backend, synchronous;
        ``PlanError`` without a ``ckpt_root``), the plan refitted with
        :meth:`for_world_size`, the step rebuilt over the first ranks of
        the world (they alone make the new groups, so a resize may follow
        another) and the state restored by ``reshard.restore_resharded``.
        The ranks past the new size leave the loop there and return what
        they ran; an
        installed health monitor stops on them and watches only the new
        size on the rest.

        Returns ``{"losses", "world_sizes", "resizes"}``, one entry a
        step run (``resizes``: ``(step_index, old_world, new_world)``),
        plus ``"resize_stats"``: each resize's save / group / restore
        seconds and the bytes saved.  ``on_step(step_count, params,
        opt_state)`` fires after every step.  The params are drawn from
        ``seed``, or start from ``params`` (full params, numpy arrays or
        tensors)."""
        import torch
        import torch.distributed as dist
        from ..models.llama import param_specs, shard_params
        from ..runtime import health as _health
        from . import collective as C
        from .fault_tolerance import CheckpointManager, step_dir_name
        from .fleet.elastic import _scale_key
        from .mesh import set_topology
        from .reshard import _flat, gather_train_state, restore_resharded
        plan = self
        step_fn, init_fn = plan.train_step(cfg, optimizer=optimizer,
                                           verify=verify, device=device)
        topo = step_fn.plan_topology
        if params is None:
            params, opt_state = init_fn(seed)
        else:
            params, opt_state = init_fn(params=shard_params(
                cfg, params, topo, device=device,
                virtual_pp=step_fn.virtual_pp))
        dev = _flat(params)[0][1].device

        def _agreed_scale():
            if scale_store is None:
                return None
            want = -1
            if topo.rank == 0:
                raw = scale_store.get(_scale_key(job_id))
                if raw is not None:
                    want = int(raw.decode() if isinstance(raw, bytes)
                               else raw)
            pg = C.resolve_group(topo.all_ranks())
            if pg is not None:
                t = torch.tensor([want], dtype=torch.int64, device=(
                    dev if dist.get_backend(pg) == "nccl" else "cpu"))
                C._broadcast(t, 0, pg)
                want = int(t.item())
            return None if want < 0 else want

        history = {"losses": [], "world_sizes": [], "resizes": [],
                   "resize_stats": []}
        status = {"job_id": job_id, "step": 0, "loss": None,
                  "world_size": plan.world_size, "done": False}
        _exporter.maybe_serve("train", lambda: dict(status))
        for batch in batches:
            step_idx = len(history["losses"])
            want = _agreed_scale()
            # the ranks past a resize have left: a plan can only shrink
            if want is not None and 0 < want < plan.world_size:
                if ckpt_root is None:
                    raise PlanError(
                        "resize requested but run_train_loop was given "
                        "no ckpt_root to reshard through")
                t0 = time.perf_counter()
                state = gather_train_state(params, opt_state, topo,
                                           virtual_pp=step_fn.virtual_pp)
                if topo.rank == 0:
                    CheckpointManager(ckpt_root, backend="pickle",
                                      sync=True, track_rng=False,
                                      specs=param_specs(cfg)).save(
                        step_idx, state)
                C.barrier(topo.all_ranks())
                saved = os.path.join(os.path.abspath(ckpt_root),
                                     step_dir_name(step_idx))
                del state, params, opt_state
                t1 = time.perf_counter()
                old = plan.world_size
                plan = plan.for_world_size(want)
                mon = _health.get()
                if topo.rank >= want:
                    # a leaver goes; its monitor stops beating
                    set_topology(None)
                    if mon is not None:
                        mon.stop()
                    history["resizes"].append((step_idx, old, want))
                    break
                if mon is not None:
                    mon.shrink(want)
                step_fn, init_fn = plan.train_step(
                    cfg, optimizer=optimizer, verify=verify,
                    device=device, ranks=want)
                topo = step_fn.plan_topology
                set_topology(topo)
                t2 = time.perf_counter()
                state, _ = restore_resharded(ckpt_root, step=step_idx,
                                             topo=topo, device=dev,
                                             virtual_pp=step_fn.virtual_pp)
                params, opt_state = init_fn(params=state["params"])
                opt_state.load_state_tree(state["opt_state"])
                del state
                history["resizes"].append((step_idx, old, want))
                history["resize_stats"].append(dict(
                    step=step_idx, old=old, new=want, save_s=t1 - t0,
                    group_s=t2 - t1, restore_s=time.perf_counter() - t2,
                    saved_bytes=_dir_bytes(saved)))
                status["world_size"] = want
            params, opt_state, m = step_fn(params, opt_state,
                                           step_fn.shard_batch(batch))
            history["losses"].append(float(m["loss"]))
            history["world_sizes"].append(plan.world_size)
            if on_step is not None:
                on_step(len(history["losses"]), params, opt_state)
            status.update(step=len(history["losses"]),
                          loss=history["losses"][-1])
        status["done"] = True
        return history


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)
