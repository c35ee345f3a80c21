"""Deterministic fault injection: the port's copy of
``paddle_tpu/testing/chaos.py``.

The framework plants named *chaos points* in its persistence, rendezvous
and step code (checkpoint commit, ``framework.io`` save, store client
ops, collectives, the heartbeat loop, the serving step).  A test
installs a :class:`Chaos` schedule and every matching point fires an
injected fault:

    crash       os._exit(code)        — kill -9 mid-save semantics
    raise       raise ChaosError      — in-process crash simulation
    sigterm     SIGTERM to self       — preemption notice
    hang        sleep forever (or ``secs=`` seconds) — a stuck worker;
                the watchdog / health layer must detect and convert it
    stall       sleep ``secs=`` (default 1.0) then continue — a slow
                rank or step that recovers on its own
    disconnect  raise ConnectionResetError — transient store failure
    truncate    truncate the file at the point's ``path``
    fail        alias of ``raise`` (the serving spelling:
                ``fail@serve.step:rid=K`` blames one request)
    kill        raise ReplicaKilled — whole-replica death (the router
                must fail over); under ``set_kill_mode("process")``
                ``os._exit`` — a gang peer's sudden death
    exhaust     grab every free page of the hit's ``pool=`` allocator
                (noisy neighbour); ``Chaos.release_exhausted()`` frees

Serving rules can carry ``rid=K`` to fire only when request id K is in
the hit's batch (the ``rids=`` kwarg) — deterministic bisection blame.

Gang-aware options: ``rank=`` fires only on that trainer
(``PADDLE_TRAINER_ID``) and ``restart=`` only in that elastic
generation (``PADDLE_RESTART_COUNT``), matched at fire time because the
environment is inherited by every rank and every generation.
``resize=N`` publishes an elastic scale request to the gang's launcher
just before the action fires, so
``kill@collective.all_reduce:step=3,rank=1,restart=0,resize=2`` kills a
4-worker generation and brings the job back with 2.

Schedules are deterministic: rules match on point name (an fnmatch
pattern), optional ``step``, fire at most ``times`` times after skipping
``after`` hits, and ``prob=`` rules draw from a seeded RNG, so a given
seed always injects the same faults in the same order.

Spec grammar (also read from the ``PTQ_CHAOS`` environment variable at
import, so subprocess workers opt in without code changes)::

    action@point[:key=value[,key=value...]][;action@point...]

    PTQ_CHAOS="crash@ckpt.commit.pre:step=3" python train.py
    PTQ_CHAOS="disconnect@store.get:times=2;sigterm@train.step:step=5"

With no schedule installed :func:`chaos_point` is one ``None`` check.
"""
from __future__ import annotations

import fnmatch
import os
import signal
import time
from contextlib import contextmanager
from typing import Iterable, List, Optional, Union

__all__ = ["Chaos", "ChaosError", "ReplicaKilled", "Rule", "chaos_point",
           "install", "uninstall", "active", "installed",
           "install_from_env", "truncate_file", "corrupt_file",
           "set_kill_mode", "kill_mode"]

ACTIONS = ("crash", "raise", "sigterm", "hang", "stall", "disconnect",
           "truncate", "fail", "kill", "exhaust")

# injectable so infinite-hang tests can count chunks instead of sleeping
_SLEEP = time.sleep
_HANG_CHUNK_S = 60.0

# How the `kill` action dies. "raise" (default) raises ReplicaKilled so
# in-process harnesses (the serving router failover tests) can catch it;
# "process" calls os._exit(exit_code) — sudden whole-process death with
# no flush, no atexit — which is what a real gang peer loss looks like.
# The gang runtime switches to "process" at init.
_KILL_MODE = "raise"


def set_kill_mode(mode: str) -> None:
    """Select ``kill`` semantics: ``"raise"`` (ReplicaKilled, in-process
    harnesses) or ``"process"`` (``os._exit`` — real peer death)."""
    global _KILL_MODE
    if mode not in ("raise", "process"):
        raise ValueError(f"kill mode must be 'raise' or 'process', "
                         f"got {mode!r}")
    _KILL_MODE = mode


def kill_mode() -> str:
    return _KILL_MODE


class ChaosError(RuntimeError):
    """Injected in-process fault (the ``raise``/``fail`` actions)."""


class ReplicaKilled(ChaosError):
    """Injected replica death (the ``kill`` action) — the serving
    router's failover path must treat the whole replica as dead, not
    just retry the step."""


class Rule:
    """One injection: fire ``action`` when a chaos point matches."""

    def __init__(self, action: str, point: str, *, step: Optional[int] = None,
                 times: Optional[int] = None, after: int = 0,
                 prob: Optional[float] = None, exit_code: int = 42,
                 frac: float = 0.5, secs: Optional[float] = None,
                 sleep_s: Optional[float] = None,
                 rank: Optional[int] = None,
                 restart: Optional[int] = None,
                 resize: Optional[int] = None,
                 rid: Optional[int] = None):
        if action not in ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}; "
                             f"one of {ACTIONS}")
        self.action = action
        self.point = point
        self.step = step
        self.times = times
        self.after = int(after)
        self.prob = prob
        self.exit_code = int(exit_code)
        self.frac = float(frac)
        # `secs` bounds hang/stall; `sleep_s` kept as a spelling alias.
        # hang without secs sleeps FOREVER (the realistic stuck-worker
        # shape — detection is the watchdog's job, not the injector's);
        # stall without secs pauses 1s and recovers.
        if secs is None and sleep_s is not None:
            secs = sleep_s
        self.secs = None if secs is None else float(secs)
        self.rank = None if rank is None else int(rank)
        self.restart = None if restart is None else int(restart)
        self.resize = None if resize is None else int(resize)
        if self.resize is not None and self.resize < 1:
            raise ValueError(f"resize={self.resize} must be >= 1")
        # `rid=` restricts serving-step rules to hits whose batch
        # contains that request id — makes bisection blame deterministic
        self.rid = None if rid is None else int(rid)
        self.hits = 0    # matching visits (post step-filter)
        self.fired = 0   # times the fault actually fired
        self.held_pages: list = []  # pages grabbed by `exhaust`

    _INT_KEYS = {"step", "times", "after", "exit_code", "rank", "restart",
                 "resize", "rid"}
    _FLOAT_KEYS = {"prob", "frac", "sleep_s", "secs"}

    @classmethod
    def parse(cls, spec: str) -> "Rule":
        """``action@point[:k=v,...]`` -> Rule."""
        head, _, opts = spec.strip().partition(":")
        action, sep, point = head.partition("@")
        if not sep or not point:
            raise ValueError(
                f"bad chaos rule {spec!r}: expected 'action@point[:k=v]'")
        kwargs = {}
        for kv in filter(None, (s.strip() for s in opts.split(","))):
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"bad chaos option {kv!r} in {spec!r}")
            if k in cls._INT_KEYS:
                kwargs[k] = int(v)
            elif k in cls._FLOAT_KEYS:
                kwargs[k] = float(v)
            else:
                raise ValueError(f"unknown chaos option {k!r} in {spec!r}")
        return cls(action.strip(), point.strip(), **kwargs)

    def __repr__(self):
        return (f"Rule({self.action}@{self.point} step={self.step} "
                f"times={self.times} fired={self.fired})")


class Chaos:
    """A seeded, deterministic schedule of injected faults."""

    def __init__(self, rules: Union[str, Iterable] = (), seed: int = 0):
        import random
        self.rules: List[Rule] = []
        self._rng = random.Random(seed)
        self.log: list = []  # (point, step, action) for test assertions
        if isinstance(rules, str):
            for spec in filter(None, (s.strip() for s in rules.split(";"))):
                self.rules.append(Rule.parse(spec))
        else:
            for r in rules:
                self.rules.append(r if isinstance(r, Rule)
                                  else Rule.parse(r))

    def rule(self, action: str, point: str, **kw) -> "Chaos":
        """Chainable: ``Chaos().rule("raise", "ckpt.commit.pre")``."""
        self.rules.append(Rule(action, point, **kw))
        return self

    def hit(self, point: str, step: Optional[int] = None,
            path: Optional[str] = None, **kw):
        # gang gating read at fire time (once per hit, not per rule):
        # PTQ_CHAOS is inherited by every rank and every elastic
        # generation, so rules carry their own rank/restart filters
        env_rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        env_restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
        for r in self.rules:
            if not fnmatch.fnmatchcase(point, r.point):
                continue
            if r.step is not None and step != r.step:
                continue
            if r.rank is not None and env_rank != r.rank:
                continue
            if r.restart is not None and env_restart != r.restart:
                continue
            if r.rid is not None and r.rid not in (kw.get("rids") or ()):
                continue
            r.hits += 1
            if r.hits <= r.after:
                continue
            if r.times is not None and r.fired >= r.times:
                continue
            if r.prob is not None and self._rng.random() >= r.prob:
                continue
            r.fired += 1
            self.log.append((point, step, r.action))
            self._fire(r, point, step, path, kw)

    def release_exhausted(self):
        """Free every page grabbed by fired ``exhaust`` rules — the
        test's stand-in for other tenants' requests finishing.

        Refcount-aware: chaos drops only the ONE reference it took at
        ``exhaust`` time (decref, never a hard free), and skips pages
        some other path already recycled — so releasing the chaos
        tenant can never free a page a sibling request or the prefix
        cache still reads."""
        for r in self.rules:
            for alloc, pages in r.held_pages:
                held = [p for p in pages if alloc.is_held(p)]
                if held:
                    alloc.decref(held)
            r.held_pages.clear()

    def _fire(self, r: Rule, point: str, step, path, kw):
        if r.resize is not None:
            _request_resize(r.resize)
        if r.action == "crash":
            # the real thing: no cleanup, no atexit, no flush — exactly
            # what a preempted VM or OOM-killed worker looks like
            os._exit(r.exit_code)
        if r.action in ("raise", "fail"):
            raise ChaosError(f"chaos: injected crash at {point} "
                             f"(step={step})")
        if r.action == "kill":
            if _KILL_MODE == "process":
                # gang semantics: the peer vanishes mid-collective with
                # nothing flushed — survivors must detect via heartbeat
                # silence, not via an exception propagating anywhere
                os._exit(r.exit_code)
            raise ReplicaKilled(f"chaos: replica killed at {point} "
                                f"(step={step})")
        if r.action == "exhaust":
            # steal every free pool page (kw["pool"] is the serving
            # BlockAllocator) — the noisy-neighbour / fragmentation
            # shape; release_exhausted() gives them back
            alloc = kw.get("pool")
            if alloc is not None and alloc.num_free:
                pages = alloc.alloc(alloc.num_free, owner="__chaos__")
                if pages:
                    r.held_pages.append((alloc, pages))
            return
        if r.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if r.action == "hang":
            if r.secs is not None:
                _SLEEP(r.secs)
                return
            while True:  # the real thing: stuck until something kills us
                _SLEEP(_HANG_CHUNK_S)
        if r.action == "stall":
            _SLEEP(1.0 if r.secs is None else r.secs)
            return
        if r.action == "disconnect":
            raise ConnectionResetError(
                f"chaos: injected disconnect at {point} (step={step})")
        if r.action == "truncate":
            if path and os.path.isfile(path):
                truncate_file(path, keep_frac=r.frac)


def _request_resize(nproc: int):
    """The elastic-resize relaunch filter: before the rule's action
    fires, publish a scale request to this gang's launcher
    (``fleet.elastic.request_scale`` on the PADDLE_MASTER store), so a
    ``crash@train.step:step=k,resize=2`` kill is relaunched at world
    size 2 — the preempted-pod-replaced-by-a-smaller-slice shape the
    elastic reshard E2E proves out."""
    master = os.environ.get("PADDLE_MASTER")
    job_id = os.environ.get("PADDLE_JOB_ID", "default")
    if not master:
        raise RuntimeError(
            "chaos resize= needs a launcher rendezvous (PADDLE_MASTER "
            "unset): run under `python -m paddle_tpu_torch.distributed.launch "
            "--elastic`")
    from ..distributed.fleet.elastic import request_scale
    request_scale(master, job_id, int(nproc))


_ACTIVE: Optional[Chaos] = None


def chaos_point(name: str, step: Optional[int] = None,
                path: Optional[str] = None, **kw):
    """Instrumentation hook. No-op (one None check) unless a schedule is
    installed via :func:`install` / ``PTQ_CHAOS``."""
    if _ACTIVE is None:
        return
    _ACTIVE.hit(name, step=step, path=path, **kw)


def install(chaos: Chaos) -> Chaos:
    global _ACTIVE
    _ACTIVE = chaos
    return chaos


def uninstall():
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Chaos]:
    return _ACTIVE


@contextmanager
def installed(chaos: Union[Chaos, str]):
    """``with chaos.installed(Chaos().rule(...)):`` — scoped injection."""
    c = chaos if isinstance(chaos, Chaos) else Chaos(chaos)
    prev = _ACTIVE
    install(c)
    try:
        yield c
    finally:
        install(prev) if prev is not None else uninstall()


def install_from_env() -> Optional[Chaos]:
    """Activate the schedule in ``PTQ_CHAOS`` (seed: ``PTQ_CHAOS_SEED``).
    Called at import so subprocess workers need only the env var."""
    spec = os.environ.get("PTQ_CHAOS")
    if not spec:
        return None
    return install(Chaos(spec, seed=int(os.environ.get("PTQ_CHAOS_SEED",
                                                       "0"))))


# -- file corruption helpers (manifest/fallback tests) -----------------------

def truncate_file(path: str, keep_frac: float = 0.5):
    """Cut a file short — what a crashed writer leaves behind."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_frac))
    with open(path, "r+b") as f:
        f.truncate(keep)


def corrupt_file(path: str, nbytes: int = 8, seed: int = 0):
    """Flip ``nbytes`` bytes at seeded offsets (bit-rot / torn write)."""
    import random
    rng = random.Random(seed)
    size = os.path.getsize(path)
    if size == 0:
        return
    with open(path, "r+b") as f:
        for _ in range(nbytes):
            off = rng.randrange(size)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


install_from_env()
