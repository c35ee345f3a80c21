"""One-host launchers: ``spawn`` (a function on every rank of a fresh
world) and the pod supervisor ``python -m
paddle_tpu_torch.distributed.launch`` (the port of
``paddle_tpu/distributed/launch/__init__.py``).

``spawn(fn, nprocs, args)`` serves a ``TCPStore`` from the calling
process, starts ``nprocs`` processes by the ``spawn`` method (fresh
interpreters: ``fn`` and its arguments are pickled, ``fn`` by import
path), and in each joins the process group through
``init_parallel_env`` before it calls ``fn(*args)``.  It returns the
ranks' results in rank order.  A rank that raises fails the call with
its traceback; a rank that dies, or a world that runs past ``timeout``,
fails it too, and every process is stopped before ``spawn`` returns or
raises.  Several cards take ``torchrun --nproc_per_node N`` instead,
whose ranks call ``init_parallel_env()`` themselves.

The pod supervisor (``LocalJob``; ``fleet.elastic.ElasticJob`` under
``--elastic``) starts ``--nproc_per_node`` worker processes of a script
or module and serves their rendezvous ``TCPStore``: workers get
PADDLE_MASTER / MASTER_ADDR / MASTER_PORT / PADDLE_TRAINER_ID /
PADDLE_TRAINERS_NUM / PADDLE_JOB_ID / PADDLE_RESTART_COUNT, the
contract ``distributed.gang.init_gang`` reads.  Worker stdout/stderr
stream to ``<log_dir>/workerlog.<rank>``, each rank's incident sidecar
lands beside it, and a failure teardown writes
``<log_dir>/pod_incidents.jsonl``.  Failure policy is gang semantics:
one dead rank (or, with ``--heartbeat_timeout``, one whose heartbeat
stalls) tears the pod down — survivors get ``--teardown_grace`` seconds
to save and exit on their own, then SIGTERM, then SIGKILL — and the pod
restarts as a unit up to ``--max_restarts`` times; an exit of 101 (a
worker that saved and asked for a relaunch) restarts it without
spending that budget.

    python -m paddle_tpu_torch.distributed.launch [--elastic
        --min_nproc A --max_nproc B] --nproc_per_node N --max_restarts R
        --log_dir D [--module M | script] args
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue
import signal
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

from ...device import resolve_device
from ..store import TCPStore, init_parallel_env, shutdown

__all__ = ["spawn", "LocalJob", "main", "classify_exit"]


def _rank_main(fn, rank, world, port, device, backend, args, timeout, out):
    try:
        store = TCPStore("127.0.0.1", port, False, world, timeout)
        init_parallel_env(device, backend=backend, store=store, rank=rank,
                          world_size=world, timeout=timeout)
        result = fn(*args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn(fn: Callable[..., Any], nprocs: int, args: Sequence = (), *,
          device=None, backend: Optional[str] = None,
          timeout: float = 300.0) -> List[Any]:
    """``fn(*args)`` on every rank of a new world of ``nprocs`` processes
    on ``device`` (the card unless the caller names another; rank ``r``
    takes card ``r`` modulo the cards there are), over ``backend``
    (default: the device's, NCCL or gloo; several ranks on one card take
    gloo).  Returns the results by rank."""
    dev = resolve_device(device).type
    store = TCPStore("127.0.0.1", 0, True, nprocs, timeout)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, store.port, dev, backend,
                               tuple(args), timeout, out))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(nprocs)) - set(results))
                raise TimeoutError(f"ranks {missing} of {nprocs} did not "
                                   f"finish within {timeout:.0f} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in results and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} of {nprocs} died with "
                                           f"exit code {p.exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                                   f"{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == nprocs else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        store.close()
    return [results[r] for r in range(nprocs)]


def classify_exit(rc: Optional[int], escalated: bool = False) -> str:
    """Classify one worker's terminal state for the pod incident record:

    - ``clean``     — exit 0;
    - ``relaunch``  — exit 101, the cooperative elastic-relaunch code
      (``runtime.health.RELAUNCH_EXIT_CODE``): the worker detected a
      failure, saved, and asked to be respawned;
    - ``signal``    — killed by a signal (negative Popen returncode);
    - ``abandoned`` — never exited on its own: the launcher had to
      SIGKILL it (or it was still running when classified);
    - ``failed``    — any other nonzero exit.
    """
    if escalated or rc is None:
        return "abandoned"
    if rc == 0:
        return "clean"
    if rc == 101:
        return "relaunch"
    if rc < 0:
        return "signal"
    return "failed"


class _Worker:
    def __init__(self, rank: int, proc: subprocess.Popen, log_path: str):
        self.rank = rank
        self.proc = proc
        self.log_path = log_path


class LocalJob:
    """A pod of nproc workers on this host with gang restart."""

    # sentinel _watch returns when a scale event interrupts the gang
    # (only ElasticJob's _check_rescale can trigger it)
    RESCALE_RC = -1001

    def __init__(self, script: str, script_args: List[str], nproc: int,
                 master: Optional[str] = None, log_dir: str = "log",
                 job_id: str = "default", max_restarts: int = 3,
                 use_module: bool = False,
                 heartbeat_timeout: Optional[float] = None,
                 teardown_grace: float = 5.0):
        self.script = script
        self.script_args = script_args
        self.nproc = nproc
        self.log_dir = log_dir
        self.job_id = job_id
        self.max_restarts = max_restarts
        self.use_module = use_module
        self.heartbeat_timeout = heartbeat_timeout
        # failure teardown: how long surviving workers get to detect the
        # failure themselves, final-save, and flush their incident/trace
        # sidecars before the launcher starts signalling
        self.teardown_grace = float(teardown_grace)
        self.restart_count = 0
        self._store = None
        self._monitor = None
        # injectable for unit tests (no real sleeping/killing needed)
        self._sleep = time.sleep
        self._clock = time.monotonic
        if master:
            host, port = master.rsplit(":", 1)
            self.master_host, self.master_port = host, int(port)
        else:
            self.master_host, self.master_port = "127.0.0.1", 0

    def _start_store(self):
        from ..store import TCPStore
        self._store = TCPStore(self.master_host, self.master_port,
                               is_master=True, world_size=self.nproc,
                               timeout=300)
        self.master_port = self._store.port
        if self.heartbeat_timeout:
            from ..fleet.elastic import HeartbeatMonitor
            self._monitor = HeartbeatMonitor(
                self._store, self.job_id, self.nproc,
                self.heartbeat_timeout)

    def _spawn_one(self, rank: int) -> _Worker:
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(self.nproc),
            "PADDLE_MASTER": f"{self.master_host}:{self.master_port}",
            "MASTER_ADDR": self.master_host,
            "MASTER_PORT": str(self.master_port),
            "PADDLE_JOB_ID": self.job_id,
            "PADDLE_RESTART_COUNT": str(self.restart_count),
        })
        # each rank's incidents_rank<N>.jsonl lands next to its workerlog
        # unless the operator pointed them somewhere explicitly; the
        # single-file override must NOT be inherited (every rank would
        # clobber the same path)
        env.pop("PADDLE_TPU_INCIDENTS_OUT", None)
        env.setdefault("PADDLE_TPU_INCIDENT_DIR", self.log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        log_path = os.path.join(self.log_dir, f"workerlog.{rank}")
        logf = open(log_path, "ab")
        cmd = [sys.executable]
        if self.use_module:
            cmd += ["-m", self.script]
        else:
            cmd += [self.script]
        cmd += self.script_args
        proc = subprocess.Popen(cmd, env=env, stdout=logf, stderr=logf)
        logf.close()
        return _Worker(rank, proc, log_path)

    def _kill_all(self, workers, grace: Optional[float] = None,
                  trigger: Optional[str] = None):
        """Tear the gang down, classifying every worker's exit.

        Escalation ladder: (1) an optional ``grace`` window in which
        workers may exit VOLUNTARILY — survivors of a peer failure use
        it to detect, final-save, and flush incident/trace sidecars
        before exiting 101; (2) SIGTERM + 5s; (3) SIGKILL (the worker is
        then classified ``abandoned``). Returns the per-worker exit
        record list; when ``trigger`` is given, also records a
        ``pod_teardown`` incident and persists the pod-level sidecar to
        ``<log_dir>/pod_incidents.jsonl``."""
        if grace:
            deadline = self._clock() + grace
            while (self._clock() < deadline
                   and any(w.proc.poll() is None for w in workers)):
                self._sleep(0.05)
        for w in workers:
            if w.proc.poll() is None:
                try:
                    w.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        escalated = set()
        deadline = self._clock() + 5
        for w in workers:
            try:
                w.proc.wait(max(0.1, deadline - self._clock()))
            except subprocess.TimeoutExpired:
                escalated.add(w.rank)
                w.proc.kill()
                w.proc.wait()
        exits = [{"rank": w.rank, "pid": w.proc.pid,
                  "rc": w.proc.returncode,
                  "class": classify_exit(w.proc.returncode,
                                         escalated=w.rank in escalated)}
                 for w in workers]
        if trigger is not None:
            from ...runtime.watchdog import (record_incident,
                                             persist_incidents)
            record_incident("pod_teardown", trigger=trigger,
                            job_id=self.job_id,
                            restart=self.restart_count,
                            world_size=len(workers),
                            grace_s=grace or 0.0, workers=exits)
            pod_path = os.path.join(self.log_dir, "pod_incidents.jsonl")
            # the launcher's atexit flush must also target the pod file,
            # never a worker's incidents_rank<N>.jsonl (workers get a
            # cleaned env from _spawn_one, so this does not leak down)
            os.environ["PADDLE_TPU_INCIDENTS_OUT"] = pod_path
            try:
                persist_incidents(pod_path)
            except OSError as exc:
                sys.stderr.write(
                    f"launch: pod incident persist failed: {exc}\n")
        return exits

    def run(self, poll_interval: float = 0.2) -> int:
        """Run to completion with gang restart; returns the exit code."""
        if self._store is None:
            self._start_store()
        while True:
            workers = [self._spawn_one(r) for r in range(self.nproc)]
            rc = self._watch(workers, poll_interval)
            if rc == 0:
                return 0
            if self.restart_count >= self.max_restarts:
                sys.stderr.write(
                    f"launch: pod failed rc={rc} after "
                    f"{self.restart_count} restarts (budget "
                    f"{self.max_restarts}); giving up\n")
                return rc
            self.restart_count += 1
            sys.stderr.write(
                f"launch: worker failure rc={rc}; gang restart "
                f"{self.restart_count}/{self.max_restarts}\n")

    def _watch(self, workers, poll_interval) -> int:
        """Block until all workers exit 0 (return 0) or any fails
        (kill the gang, return its rc)."""
        if self._monitor is not None:
            self._monitor.reset()
        try:
            while True:
                alive = False
                for w in workers:
                    rc = w.proc.poll()
                    if rc is None:
                        alive = True
                    elif rc != 0:
                        sys.stderr.write(
                            f"launch: rank {w.rank} exited rc={rc} "
                            f"(log: {w.log_path})\n")
                        exits = self._kill_all(
                            workers, grace=self.teardown_grace,
                            trigger=f"rank {w.rank} exited rc={rc}")
                        return self._pod_rc(rc, exits)
                if not alive:
                    return 0
                if self._check_rescale():
                    self._kill_all(workers)
                    return self.RESCALE_RC
                if self._monitor is not None:
                    stale = self._monitor.stale_ranks(self.restart_count)
                    stale = [r for r in stale
                             if workers[r].proc.poll() is None]
                    if stale:
                        sys.stderr.write(
                            f"launch: ranks {stale} heartbeat-stale "
                            f"(> {self.heartbeat_timeout}s): "
                            "declaring hung\n")
                        exits = self._kill_all(
                            workers, grace=self.teardown_grace,
                            trigger=f"ranks {stale} heartbeat-stale")
                        return self._pod_rc(1, exits)
                time.sleep(poll_interval)
        except BaseException:
            # ctrl-C, store errors from the rescale poll, anything: the
            # gang must never be orphaned behind a dead supervisor
            self._kill_all(workers)
            raise

    @staticmethod
    def _pod_rc(rc: int, exits) -> int:
        """Pod exit code after a failure teardown. If ANY worker exited
        with the cooperative relaunch code during the grace window (a
        survivor that detected the failure, saved, and asked for a
        respawn), the pod's verdict is 101 — the elastic supervisor then
        relaunches without burning restart budget even when the
        first-detected rc was a raw crash code."""
        if any(e["class"] == "relaunch" for e in exits):
            return 101
        return rc

    def _check_rescale(self) -> bool:
        return False  # fixed-size pods never rescale

    def close(self):
        if self._store is not None:
            self._store.close()
            self._store = None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle_tpu_torch distributed launcher "
                    "(reference: paddle.distributed.launch)")
    parser.add_argument("--nproc_per_node", type=int,
                        default=int(os.environ.get("PADDLE_NPROC", "1")))
    parser.add_argument("--master", default=None,
                        help="host:port of the rendezvous TCPStore "
                             "(default: serve one locally)")
    parser.add_argument("--job_id", default="default")
    parser.add_argument("--log_dir", default="log")
    parser.add_argument("--max_restarts", type=int, default=3)
    parser.add_argument("--heartbeat_timeout", type=float, default=None,
                        help="declare a rank hung when its heartbeat "
                             "(fleet.elastic.start_heartbeat) stalls "
                             "this many seconds; hung pods gang-restart")
    parser.add_argument("--teardown_grace", type=float, default=5.0,
                        help="failure teardown: seconds surviving "
                             "workers get to exit voluntarily (final "
                             "save + incident/trace sidecar flush) "
                             "before SIGTERM/SIGKILL escalation")
    parser.add_argument("--module", action="store_true",
                        help="run script as a python module (-m)")
    parser.add_argument("--elastic", action="store_true",
                        help="supervise with the elastic manager: scale "
                             "events via the job store, exit-101 relaunch "
                             "protocol (fleet.elastic.ElasticJob)")
    parser.add_argument("--min_nproc", type=int, default=1,
                        help="elastic: lower world-size bound")
    parser.add_argument("--max_nproc", type=int, default=None,
                        help="elastic: upper world-size bound "
                             "(default: --nproc_per_node)")
    parser.add_argument("--scale", type=int, default=None, metavar="N",
                        help="operator mode: ask the running job at "
                             "--master/--job_id to rescale to N workers, "
                             "then exit (no script needed)")
    parser.add_argument("script", nargs="?")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.scale is not None:
        if not args.master:
            parser.error("--scale requires --master host:port")
        from ..fleet.elastic import request_scale
        request_scale(args.master, args.job_id, args.scale)
        return 0
    if not args.script:
        parser.error("script is required (unless using --scale)")

    if args.elastic:
        from ..fleet.elastic import ElasticJob
        job = ElasticJob(args.script, args.script_args,
                         args.nproc_per_node, min_nproc=args.min_nproc,
                         max_nproc=args.max_nproc,
                         master=args.master, log_dir=args.log_dir,
                         job_id=args.job_id,
                         max_restarts=args.max_restarts,
                         use_module=args.module,
                         heartbeat_timeout=args.heartbeat_timeout,
                         teardown_grace=args.teardown_grace)
    else:
        job = LocalJob(args.script, args.script_args, args.nproc_per_node,
                       master=args.master, log_dir=args.log_dir,
                       job_id=args.job_id, max_restarts=args.max_restarts,
                       use_module=args.module,
                       heartbeat_timeout=args.heartbeat_timeout,
                       teardown_grace=args.teardown_grace)
    try:
        return job.run()
    finally:
        job.close()
