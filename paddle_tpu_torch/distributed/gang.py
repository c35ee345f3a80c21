"""Real multi-process gang runtime: a train loop across process
boundaries (the port of ``paddle_tpu/distributed/gang.py``).

A pod of trainer processes, started by ``python -m
paddle_tpu_torch.distributed.launch``, rendezvous over the launcher's
``TCPStore``, join one ``torch.distributed`` process group (NCCL when
each rank has a card of its own, gloo when several share one card or on
the CPU), and each rank binds its ``HealthMonitor`` / ``Watchdog`` /
flight recorder to its real pid.

One rank's lifecycle::

    ctx = gang.init_gang()              # store + process group + mesh
                                        # + health monitor, all wired
    with ctx.running():                 # failure -> save -> exit 101
        for step in ...:
            params, opt, m = step_fn(params, opt, batch)
            ctx.step_boundary(step, params, opt)
    ctx.shutdown(0)                     # sidecars + ordered teardown

Failure semantics: when a REAL peer dies or hangs mid-collective, every
surviving rank detects it within the heartbeat / collective-beacon
deadline (``runtime/health.py``) or through the collective's own error,
writes a final step-boundary checkpoint from the snapshot
``step_boundary`` took, flushes its incident and trace sidecars, and
exits 101 — the cooperative relaunch code the launcher honors.  The
relaunched generation restores through ``reshard.restore_resharded``
(possibly at a different world size) and resumes the trajectory.

Where the port differs from the reference:

- ``torch.optim`` updates parameters and moments in place, so the
  final-save box holds a *snapshot* (``checkpoint.snapshot``: a device
  copy queued on the step's stream, no host sync), not the live tree; a
  step cannot alter what a later failure saves.  The final save runs on
  the monitor thread, issues no collective, and copies to the host on a
  stream of its own that waits only for the snapshot's event, so it
  never queues behind a kernel the main thread is stuck on.
- Every generation's process group takes keys prefixed by its restart
  count on the launcher's store, so generation 1 never reads
  generation 0's rendezvous.
- SIGTERM (the launcher's teardown, a preemption notice) is latched by a
  ``PreemptionHandler``: the rank finishes its step, saves at the
  boundary and exits 101, where a stuck rank is converted by its monitor.
  The reference's JAX runtime catches SIGTERM the same way (its
  preemption notifier), so a pod torn down for a resize resumes from the
  boundary it reached.

``python -m paddle_tpu_torch.distributed.gang`` is the runnable preset:
the bench multichip llama config driven through ``Plan.run_train_loop``
under a real gang, printing one ``GANG_RESULT {json}`` line per rank
(``python -m paddle_tpu_torch.bench --multichip --gang N`` folds them
into one result).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from ..profiler import trace as _trace
from ..runtime import health as _health
from ..runtime.watchdog import (Watchdog, incidents, persist_incidents,
                                record_incident)
from ..testing import chaos as _chaos

__all__ = ["GangConfig", "GangContext", "init_gang", "main"]


@dataclasses.dataclass
class GangConfig:
    """Tunables for one gang worker. ``from_env`` reads the
    ``PTQ_GANG_*`` overrides the launcher/test environment passes down
    (every knob also has a constructor default sized for real pods —
    tests shrink the deadlines to keep E2Es fast).  The reference's
    ``coordinator_host`` is gone: the process group forms over the
    launcher's store, with no coordinator of its own."""

    heartbeat_interval: float = 1.0
    heartbeat_timeout: float = 5.0
    collective_deadline: Optional[float] = None  # None -> watchdog flag
    straggler_skew: int = 5
    rendezvous_timeout: float = 60.0
    trace_dir: Optional[str] = None
    ckpt_root: Optional[str] = None
    # chaos `kill` rules become os._exit (sudden real peer death) rather
    # than an in-process ReplicaKilled exception
    process_kill_mode: bool = True
    # also beat the fleet.elastic hb keys so a launcher started with
    # --heartbeat_timeout can declare the whole pod hung
    launcher_heartbeat: bool = True

    _ENV = {
        "PTQ_GANG_HEARTBEAT_INTERVAL": ("heartbeat_interval", float),
        "PTQ_GANG_HEARTBEAT_TIMEOUT": ("heartbeat_timeout", float),
        "PTQ_GANG_COLLECTIVE_DEADLINE": ("collective_deadline", float),
        "PTQ_GANG_STRAGGLER_SKEW": ("straggler_skew", int),
        "PTQ_GANG_RENDEZVOUS_TIMEOUT": ("rendezvous_timeout", float),
        "PTQ_GANG_TRACE_DIR": ("trace_dir", str),
        "PTQ_GANG_CKPT_ROOT": ("ckpt_root", str),
    }

    @classmethod
    def from_env(cls, **overrides) -> "GangConfig":
        kw: Dict[str, Any] = {}
        for var, (field, cast) in cls._ENV.items():
            raw = os.environ.get(var)
            if raw:
                kw[field] = cast(raw)
        kw.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**kw)


class GangContext:
    """One rank's handle on a live gang: the rendezvous store, the
    health monitor bound to this process, the final-save snapshot box,
    and the teardown protocol."""

    def __init__(self, config: GangConfig, store, rank: int,
                 world_size: int, restart: int, job_id: str,
                 owns_store: bool = False, device=None):
        self.config = config
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.restart = int(restart)
        self.job_id = job_id
        self.pid = os.getpid()
        self.device = resolve_device(device)
        self.monitor: Optional[_health.HealthMonitor] = None
        self.watchdog: Optional[Watchdog] = None
        self.preemption = None
        self._owns_store = owns_store
        self._hb_stop = None
        self._final_box: Dict[str, Any] = {}
        self._finalized = False

    # -- training-loop integration ------------------------------------------

    def step_boundary(self, step: int, params=None, opt_state=None):
        """Per-step hook (``run_train_loop(on_step=...)`` shape): stamp
        the health step, hand a snapshot of the just-completed state to
        the final-save box, record the step barrier, honor a latched
        SIGTERM (final save, exit 101), and pass the step's collective
        beacon.

        Ordering matters: the step stamp and the snapshot land BEFORE
        the ``all_reduce`` below — over this rank alone, so it moves
        nothing (the reference's is the identity outside a trace), but
        it fires the health collective beacon and the
        ``collective.all_reduce`` chaos point, so a ``kill@``/``hang@``
        rule matching this step bites a rank whose snapshot already
        holds this step's state (survivors and self-detectors then
        final-save exactly the crash-step checkpoint).  ``opt_state``
        is a ``ZeroOptimizer`` (its state by parameter path, with every
        leaf's placement) or any tree."""
        if self.monitor is not None:
            self.monitor.set_step(int(step))
        else:
            _health.set_step(int(step))
        if params is not None:
            from . import checkpoint as dckpt
            from . import reshard
            zero = hasattr(opt_state, "state_tree")
            tree = {"params": params,
                    "opt_state": opt_state.state_tree() if zero
                    else opt_state}
            self._final_box = {
                "step": int(step), "snapshot": dckpt.snapshot(tree),
                "specs": reshard.train_state_specs(opt_state) if zero
                else {},
                "param_specs": dict(opt_state.specs) if zero else None,
                "topo": opt_state.topo if zero else None}
        _trace.barrier(f"gang/step{step}")
        if self.preemption is not None and self.preemption.requested():
            self.abort(f"preemption notice (SIGTERM) at step {step}")
        from .collective import all_reduce
        from .mesh import ONE_RANK
        all_reduce(torch.zeros((), device=self.device), group=ONE_RANK)

    def final_save(self):
        """Write the last step-boundary snapshot as a committed
        checkpoint. Runs on the MONITOR thread during failure
        conversion (the main thread may be hung inside a collective),
        so it only touches the snapshot and issues no collective: a
        leaf a peer partly holds raises (``reshard.host_full``)."""
        box = self._final_box
        root = self.config.ckpt_root
        if not box or not root:
            return
        if self.world_size > 1:
            # gang coordination: first claimant owns the step's save —
            # survivors all hold identical (replicated) state, so one
            # commit suffices and concurrent commits to one root would
            # race on the step's tmp dir. Store down -> save anyway:
            # worst case is a racy duplicate, never a lost checkpoint.
            try:
                claim = self.store.add(
                    f"gang/save/{self.restart}/{box['step']}", 1)
                if claim > 1:
                    return
            except Exception:  # noqa: BLE001
                pass
        from . import checkpoint as dckpt
        from .fault_tolerance import CheckpointManager
        from .reshard import _unflat, host_full
        specs, topo = box["specs"], box["topo"]
        state = _unflat(dckpt.host_copy(box["snapshot"]),
                        lambda p, x: host_full(x, specs.get(p), topo)
                        if torch.is_tensor(x) else x)
        CheckpointManager(root, backend="pickle", sync=True,
                          specs=box["param_specs"]).save(box["step"],
                                                         state)

    @contextmanager
    def running(self):
        """Scope the training loop: an exception escaping it (a gloo
        collective erroring out under a dead peer, a poisoned step)
        converts to the save-and-exit-101 path instead of an arbitrary
        crash code."""
        try:
            yield self
        except SystemExit:
            raise
        except BaseException as exc:  # noqa: BLE001 — KeyboardInterrupt too
            self.abort(f"{type(exc).__name__}: {exc}")

    # -- failure conversion --------------------------------------------------

    def abort(self, reason: str):
        """Main-thread failure path: record, then route through the
        monitor's conversion (final save + gang fail flag + incident
        flush + exit 101). If another thread already converted, wait
        for its exit; a hard exit-101 backstop guarantees this call
        never returns."""
        record_incident("gang_abort", reason=str(reason)[-500:],
                        gang_rank=self.rank)
        m = self.monitor
        if m is not None:
            m._convert(f"rank {self.rank}: {reason}")
            # _convert returned -> a conversion is already in flight on
            # the monitor thread; give it time to save and exit us
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                time.sleep(0.1)
        try:
            self.final_save()
        except Exception as e:  # noqa: BLE001
            record_incident("final_save_failed", error=str(e)[-500:])
        try:
            persist_incidents()
        except OSError:
            pass
        os._exit(_health.RELAUNCH_EXIT_CODE)

    # -- teardown ------------------------------------------------------------

    def finalize(self, status: str = "ok"):
        """Flush this rank's flight-recorder sidecar (terminal barrier
        last) and stop the background threads. Idempotent; does not
        exit. The incident buffer is only persisted when non-empty so a
        clean relaunched generation never clobbers the previous
        generation's post-mortem files."""
        if self._finalized:
            return
        self._finalized = True
        if _trace.enabled():
            _trace.barrier(_trace.TERMINAL_BARRIER, status=status,
                           step=(self._final_box or {}).get("step"))
            if self.config.trace_dir:
                os.makedirs(self.config.trace_dir, exist_ok=True)
                _trace.write_sidecar(
                    _trace.sidecar_path(self.config.trace_dir, self.rank),
                    extra={"world_size": self.world_size,
                           "restart": self.restart, "status": status})
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self.monitor is not None:
            self.monitor.stop()
            if _health.get() is self.monitor:
                _health.uninstall()
        if self.preemption is not None:
            self.preemption.uninstall()
        if incidents():
            try:
                persist_incidents()
            except OSError:
                pass

    def shutdown(self, exit_code: int = 0):
        """Orderly gang teardown: finalize sidecars, align every rank
        on the exit barrier, then leave the process group and the
        store."""
        self.finalize(status="ok" if exit_code == 0
                      else f"exit{exit_code}")
        if self.world_size > 1:
            try:
                self.store.barrier(f"gang/done/{self.restart}",
                                   rank=self.rank,
                                   timeout=self.config.rendezvous_timeout)
            except Exception as e:  # peers died mid-exit: still leave
                sys.stderr.write(f"gang: exit barrier skipped: {e}\n")
        from .store import shutdown as _dist_shutdown
        _dist_shutdown()
        try:
            self.store.close()
        except Exception:  # noqa: BLE001
            pass


def _init_process_group(store, rank: int, world: int, restart: int,
                        cfg: GangConfig, device: torch.device):
    """Join the gang's process group over the launcher's store, with
    this generation's keys (``gang/<restart>/``).  NCCL when every rank
    has a card of its own, gloo when several share one (NCCL refuses
    two ranks on one device) or on the CPU.  The group's timeout bounds
    a collective a dead peer never answers (the default is 30 min)."""
    from .store import init_parallel_env
    backend = "gloo"
    if device.type == "cuda" and world <= torch.cuda.device_count():
        backend = "nccl"
    timeout = max(cfg.rendezvous_timeout, cfg.collective_deadline or 0.0)
    init_parallel_env(device, backend=backend, store=store, rank=rank,
                      world_size=world, timeout=timeout,
                      prefix=f"gang/{restart}/")


def init_gang(config: Optional[GangConfig] = None, *,
              device=None) -> GangContext:
    """Bring this process up as one rank of a real gang on ``device``
    (the card unless the caller names another).

    Reads the launcher env contract (PADDLE_TRAINER_ID /
    PADDLE_TRAINERS_NUM / PADDLE_MASTER / PADDLE_RESTART_COUNT), joins
    the rendezvous store, runs the named-rank boot barrier (a wedged
    peer is called out BY RANK in the TimeoutError), joins the process
    group and the global topology, latches SIGTERM, and starts the
    HealthMonitor bound to this real pid. Single-process (world 1, no
    PADDLE_MASTER) degrades to a self-owned store with the same API so
    unit tests and notebooks run the identical code path."""
    cfg = config if config is not None else GangConfig.from_env()
    env = os.environ
    rank = int(env.get("PADDLE_TRAINER_ID", "0"))
    world = int(env.get("PADDLE_TRAINERS_NUM", "1"))
    restart = int(env.get("PADDLE_RESTART_COUNT", "0"))
    job_id = env.get("PADDLE_JOB_ID", "gang")
    master = env.get("PADDLE_MASTER")
    dev = resolve_device(device)

    if cfg.process_kill_mode:
        _chaos.set_kill_mode("process")

    from .store import TCPStore
    owns = False
    if master and world > 1:
        host, port = master.rsplit(":", 1)
        store = TCPStore(host, int(port), is_master=False,
                         world_size=world,
                         timeout=cfg.rendezvous_timeout)
    else:
        store = TCPStore("127.0.0.1", 0, is_master=True,
                         world_size=world,
                         timeout=cfg.rendezvous_timeout)
        owns = True

    wd = Watchdog(deadlines={"gang.rendezvous": cfg.rendezvous_timeout})
    with wd.phase("gang.rendezvous"):
        store.barrier(f"gang/boot/{restart}", rank=rank,
                      timeout=cfg.rendezvous_timeout)
        if world > 1:
            _init_process_group(store, rank, world, restart, cfg, dev)
    from .mesh import init_mesh
    init_mesh()

    ctx = GangContext(cfg, store, rank, world, restart, job_id,
                      owns_store=owns, device=dev)
    ctx.watchdog = wd
    from .fault_tolerance import PreemptionHandler
    ctx.preemption = PreemptionHandler(signals=(signal.SIGTERM,))

    monitor = _health.HealthMonitor(
        store, rank, world, job_id=job_id, restart=restart,
        heartbeat_interval=cfg.heartbeat_interval,
        heartbeat_timeout=cfg.heartbeat_timeout,
        collective_deadline=cfg.collective_deadline,
        straggler_skew=cfg.straggler_skew)
    monitor.register_final_save(ctx.final_save)
    _health.install(monitor)
    monitor.start()
    ctx.monitor = monitor

    if cfg.launcher_heartbeat and master and world > 1:
        from .fleet.elastic import start_heartbeat
        ctx._hb_stop = start_heartbeat(cfg.heartbeat_interval,
                                       store=store)

    _trace.barrier(f"gang/boot{restart}", rank_pid=ctx.pid)
    return ctx


# ---------------------------------------------------------------------------
# runnable preset: the bench multichip llama config under a real gang
# ---------------------------------------------------------------------------

def _preset_result(ctx: GangContext, plan, history,
                   step_ms: float) -> Dict[str, Any]:
    from .overlap import schedule_events
    matches = None
    if _trace.enabled() and plan.pp > 1:
        recorded = _trace.pipeline_schedule_events(_trace.events())
        static = schedule_events(plan.pp,
                                 plan.n_microbatches or plan.pp,
                                 overlap=plan.overlap)
        matches = recorded == static
    return {
        "rank": ctx.rank, "pid": ctx.pid,
        "world_size": ctx.world_size, "restart": ctx.restart,
        "plan": plan.dims, "schedule": plan.schedule,
        "n_microbatches": plan.n_microbatches,
        "overlap": plan.overlap,
        "steps": len(history["losses"]),
        "losses": [float(x) for x in history["losses"]],
        "step_ms": round(step_ms, 2),
        "matches_static": matches,
        "device": (torch.cuda.get_device_name(ctx.device)
                   if ctx.device.type == "cuda" else "cpu"),
    }


def main(argv=None) -> int:
    """``python -m paddle_tpu_torch.distributed.gang``: run the
    multichip llama preset through ``Plan.run_train_loop`` under a real
    gang and print one ``GANG_RESULT {json}`` line (parsed by ``python
    -m paddle_tpu_torch.bench --multichip --gang N`` and the gang E2E
    tests). The pipeline spans the processes: with N ranks, ``pp=N``
    1F1B p2p crosses real process boundaries.  The model is the bench's
    multichip one: float32 at hidden 64 on the CPU, bfloat16 at hidden
    256 (4 heads of 64, what the flash kernels take) on the card."""
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.gang")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--trace-out", default=None,
                   help="flight-recorder sidecar dir (enables tracing)")
    p.add_argument("--ckpt-root", default=None)
    p.add_argument("--n-micro", type=int, default=4)
    p.add_argument("--no-overlap", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from ..flags import set_flags
    set_flags({"FLAGS_tpu_trace": args.trace_out is not None})

    cfg = GangConfig.from_env(trace_dir=args.trace_out,
                              ckpt_root=args.ckpt_root)
    ctx = init_gang(cfg, device=args.device)
    if ctx.device.type == "cpu":
        torch.set_num_threads(1)      # the ranks share the host's cores

    import numpy as np
    from ..bench import MULTICHIP_MODEL, MULTICHIP_MODEL_CARD
    from ..models.llama import LlamaConfig
    from .plan import Plan

    model_cfg = LlamaConfig(**(MULTICHIP_MODEL_CARD
                               if ctx.device.type == "cuda"
                               else MULTICHIP_MODEL))
    if ctx.world_size > 1:
        plan = Plan(pp=ctx.world_size, schedule="1f1b",
                    n_microbatches=args.n_micro,
                    overlap=not args.no_overlap)
    else:
        plan = Plan()

    rng = np.random.default_rng(0)
    B, S = args.batch, args.seq
    batches = [{
        "input_ids": rng.integers(0, model_cfg.vocab_size, (B, S),
                                  dtype=np.int64),
        "labels": rng.integers(0, model_cfg.vocab_size, (B, S),
                               dtype=np.int64),
    } for _ in range(args.steps)]

    t0 = time.perf_counter()
    with ctx.running():
        history = plan.run_train_loop(model_cfg, batches,
                                      on_step=ctx.step_boundary,
                                      device=ctx.device)
    step_ms = (time.perf_counter() - t0) / max(1, args.steps) * 1e3

    result = _preset_result(ctx, plan, history, step_ms)
    print("GANG_RESULT " + json.dumps(result, sort_keys=True),
          flush=True)
    ctx.shutdown(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
