"""Elastic training: heartbeats, staleness monitor, relaunch protocol,
scale up/down (the port of ``paddle_tpu/distributed/fleet/elastic.py``).

Three halves:

- failure detection: process EXITS are caught by the launcher's
  poll-based watchdog, in-process HANGS by heartbeat staleness
  (``start_heartbeat`` / ``HeartbeatMonitor``);
- cooperative relaunch: ``ElasticJob`` honors RELAUNCH_EXIT_CODE without
  consuming the restart budget (the reference manager's exit-code-101
  contract);
- scale events: the world size is a watched key in the job's TCPStore
  (``request_scale`` writes it — the etcd-watch analog); on change the
  gang is torn down and respawned at the new size, clamped to
  [min_nproc, max_nproc], with PADDLE_TRAINERS_NUM re-rendered. Workers
  resume from their latest checkpoint (``reshard.restore_resharded``
  re-slices it onto the new topology).

Heartbeats ride the store the launcher already serves for rendezvous
(``torch.distributed.TCPStore`` behind ``distributed.store``). Each beat
is a counter increment; the monitor compares counter *changes* against
its own clock, so worker/launcher clock skew cannot cause false
positives. Workers opt in by calling ``start_heartbeat()``; ranks that
never beat are not monitored, so scripts that don't cooperate simply
keep exit-code-only supervision.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["start_heartbeat", "HeartbeatMonitor", "ElasticJob",
           "request_scale", "RELAUNCH_EXIT_CODE"]

# Worker exit code meaning "relaunch me" (checkpoint saved, membership
# changed, re-plan wanted...). Reference: manager.py's exit-code-101
# protocol (ELASTIC_AUTO_PARALLEL_EXIT_CODE plays the same role for
# re-planning). Does not consume the restart budget.
RELAUNCH_EXIT_CODE = 101


def _hb_key(job_id: str, restart: str, rank: str) -> str:
    return f"hb/{job_id}/{restart}/{rank}"


def start_heartbeat(interval: float = 2.0, store=None) -> threading.Event:
    """Worker side: beat into the job's TCPStore from a daemon thread.
    Env contract comes from the launcher (PADDLE_MASTER / PADDLE_JOB_ID /
    PADDLE_TRAINER_ID / PADDLE_RESTART_COUNT). Returns a stop Event."""
    if store is None:
        from ..store import TCPStore
        host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
        store = TCPStore(host, int(port), is_master=False, timeout=60)
    key = _hb_key(os.environ.get("PADDLE_JOB_ID", "default"),
                  os.environ.get("PADDLE_RESTART_COUNT", "0"),
                  os.environ.get("PADDLE_TRAINER_ID", "0"))
    stop = threading.Event()

    # one synchronous beat before the thread starts: the rank is
    # monitored from the moment start_heartbeat returns, even if it
    # hangs (or the scheduler starves the thread) immediately after
    store.add(key, 1)

    def beat():
        from ...testing.chaos import chaos_point
        while not stop.is_set():
            stop.wait(interval)
            try:
                # chaos "hang@elastic.heartbeat" stalls the beat so tests
                # can prove the monitor declares this rank hung
                chaos_point("elastic.heartbeat", path=None, key=key)
                store.add(key, 1)
            except Exception:
                return  # store gone: the pod is coming down anyway

    threading.Thread(target=beat, daemon=True,
                     name="paddle-tpu-heartbeat").start()
    return stop


class HeartbeatMonitor:
    """Launcher side: declare a rank hung when its counter stops moving
    for longer than ``timeout`` (measured on the monitor's clock)."""

    def __init__(self, store, job_id: str, nproc: int, timeout: float):
        self._store = store
        self._job_id = job_id
        self.nproc = nproc  # public: elastic rescales adjust it
        self._timeout = timeout
        # rank -> (last counter value, monitor time it last changed)
        self._seen: Dict[int, tuple] = {}

    def reset(self):
        self._seen.clear()

    def stale_ranks(self, restart_count: int,
                    now: Optional[float] = None) -> List[int]:
        # monotonic: an NTP step on the launcher must not declare every
        # healthy rank hung
        now = time.monotonic() if now is None else now
        stale = []
        for rank in range(self.nproc):
            key = _hb_key(self._job_id, str(restart_count), str(rank))
            raw = self._store.get(key)
            if raw is None:
                continue  # never beat: not monitored (opt-in contract)
            try:
                val = int(raw)
            except ValueError:
                continue
            prev = self._seen.get(rank)
            if prev is None or prev[0] != val:
                self._seen[rank] = (val, now)
            elif now - prev[1] > self._timeout:
                stale.append(rank)
        return stale


def _scale_key(job_id: str) -> str:
    return f"elastic/{job_id}/world_size"


def request_scale(master: str, job_id: str, nproc: int, store=None):
    """Operator side: ask a running ElasticJob to change its world size
    (the etcd-watch analog — any party with store access can scale the
    job). ``master`` is the job's ``host:port`` rendezvous address."""
    if store is None:
        from ..store import TCPStore
        host, port = master.rsplit(":", 1)
        store = TCPStore(host, int(port), is_master=False, timeout=60)
    store.set(_scale_key(job_id), str(int(nproc)).encode())


from ..launch import LocalJob  # noqa: E402  (no import cycle: launch only
# imports fleet.elastic lazily inside functions)


class ElasticJob(LocalJob):
    """Elastic pod supervisor (ElasticManager analog, a LocalJob
    subclass overriding the _check_rescale extension point + run loop).

    Differences from a fixed LocalJob pod:
    - world size follows the store's scale key, clamped to
      [min_nproc, max_nproc]; a change tears the gang down and respawns
      at the new size without consuming the restart budget;
    - a worker exiting RELAUNCH_EXIT_CODE triggers a free gang relaunch;
    - every (re)launch increments PADDLE_RESTART_COUNT so heartbeat keys
      and rendezvous epochs never collide across generations.
    """

    def __init__(self, script, script_args, nproc, min_nproc=1,
                 max_nproc=None, **job_kwargs):
        super().__init__(script, script_args, int(nproc), **job_kwargs)
        self.min_nproc = max(1, int(min_nproc))
        self.max_nproc = int(max_nproc) if max_nproc else int(nproc)
        self._last_scale_raw = None
        self._failures = 0  # real failures only; free relaunches excluded

    # -- scale watching -----------------------------------------------------
    def _read_scale(self):
        """ONE store read -> (raw, want). All scale decisions in a cycle
        derive from the same raw value, so a request landing between two
        reads can never be half-seen and dropped."""
        raw = self._store.get(_scale_key(self.job_id))
        if raw is None:
            return None, None
        try:
            want = max(self.min_nproc, min(self.max_nproc, int(raw)))
        except ValueError:
            return raw, None
        return raw, want

    def _check_rescale(self) -> bool:
        raw, want = self._read_scale()
        if raw is None or raw == self._last_scale_raw:
            return False
        if want is None:
            sys.stderr.write(
                f"elastic: scale request {raw!r} is not an integer; "
                "ignoring\n")
            self._last_scale_raw = raw
            return False
        if want == self.nproc:
            # clamped/identical: tell the operator once rather than
            # silently swallowing the request
            sys.stderr.write(
                f"elastic: scale request {raw!r} resolves to the current "
                f"world size {self.nproc} (bounds [{self.min_nproc}, "
                f"{self.max_nproc}]); ignoring\n")
            self._last_scale_raw = raw
            return False
        return True

    # -- supervision --------------------------------------------------------
    def run(self, poll_interval: float = 0.2) -> int:
        if self._store is None:
            self._start_store()
        while True:
            raw, want = self._read_scale()
            self._last_scale_raw = raw
            if want is not None and want != self.nproc:
                self.nproc = want
                if self._monitor is not None:
                    self._monitor.nproc = want
            workers = [self._spawn_one(r) for r in range(self.nproc)]
            rc = self._watch(workers, poll_interval)
            if rc == 0:
                return 0
            # every respawn is a new generation: PADDLE_RESTART_COUNT (and
            # with it the heartbeat/rendezvous epoch) must never repeat
            self.restart_count += 1
            if rc == self.RESCALE_RC:
                sys.stderr.write(
                    "elastic: scale event; respawning gang at the new "
                    "world size\n")
                continue
            if rc == RELAUNCH_EXIT_CODE:
                sys.stderr.write(
                    "elastic: worker requested relaunch (exit 101); "
                    "respawning gang\n")
                continue
            self._failures += 1
            if self._failures > self.max_restarts:
                sys.stderr.write(
                    f"elastic: pod failed rc={rc} after exhausting "
                    f"{self.max_restarts} restarts; giving up\n")
                return rc
            sys.stderr.write(
                f"elastic: worker failure rc={rc}; gang restart "
                f"{self._failures}/{self.max_restarts}\n")

    @property
    def master(self) -> str:
        return f"{self.master_host}:{self.master_port}"
