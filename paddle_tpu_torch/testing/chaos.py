"""Deterministic fault injection: the port's copy of
``paddle_tpu/testing/chaos.py`` with the actions the serving engine's
``serve.step`` point uses.

Instrumented code calls :func:`chaos_point`; a test installs a
:class:`Chaos` schedule and every matching point fires an injected
fault:

    raise       raise ChaosError      — in-process crash simulation
    fail        alias of ``raise`` (the serving spelling:
                ``fail@serve.step:rid=K`` blames one request)
    hang        sleep forever (or ``secs=`` seconds) — a stuck call; the
                watchdog must detect and convert it
    stall       sleep ``secs=`` (default 1.0) then continue — a slow
                step that recovers on its own
    kill        raise ReplicaKilled — whole-replica death; not a
                step-recoverable fault
    exhaust     grab every free page of the hit's ``pool=`` allocator
                (noisy neighbour); ``Chaos.release_exhausted()`` frees

Rules match on point name (an fnmatch pattern), optional ``step`` and
``rid`` (fires only when request id K is in the hit's ``rids=`` batch
— deterministic bisection blame), fire at most ``times`` times after
skipping ``after`` hits, and ``prob=`` rules draw from a seeded RNG, so
a given seed always injects the same faults in the same order.

Spec grammar, as the reference parses it::

    action@point[:key=value[,key=value...]][;action@point...]

    Chaos("fail@serve.step:step=2,times=1")
    Chaos("hang@serve.step:step=3,secs=2.0;stall@serve.step:prob=0.1")

Not ported yet (they come with the checkpoint and gang runtime, ROADMAP
A3): the ``crash``, ``sigterm``, ``truncate`` and ``disconnect``
actions, the ``rank=``, ``restart=`` and ``resize=`` options, the
process-exit ``kill`` mode and the ``PTQ_CHAOS`` environment variable.
With no schedule installed :func:`chaos_point` is one ``None`` check.
"""
from __future__ import annotations

import fnmatch
import random
import time
from contextlib import contextmanager
from typing import Iterable, List, Optional, Union

__all__ = ["Chaos", "ChaosError", "ReplicaKilled", "Rule", "chaos_point",
           "install", "uninstall", "active", "installed"]

ACTIONS = ("raise", "fail", "hang", "stall", "kill", "exhaust")

# injectable so tests can count sleeps (or advance a fake clock) instead
# of sleeping
_SLEEP = time.sleep
_HANG_CHUNK_S = 60.0


class ChaosError(RuntimeError):
    """Injected in-process fault (the ``raise``/``fail`` actions)."""


class ReplicaKilled(ChaosError):
    """Injected replica death (the ``kill`` action): the whole replica
    is dead, so the step must not be retried."""


class Rule:
    """One injection: fire ``action`` when a chaos point matches."""

    def __init__(self, action: str, point: str, *, step: Optional[int] = None,
                 times: Optional[int] = None, after: int = 0,
                 prob: Optional[float] = None, secs: Optional[float] = None,
                 sleep_s: Optional[float] = None,
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
        # `secs` bounds hang/stall; `sleep_s` is a spelling alias.  hang
        # without secs sleeps FOREVER (detection is the watchdog's job);
        # stall without secs pauses 1 s and recovers
        if secs is None and sleep_s is not None:
            secs = sleep_s
        self.secs = None if secs is None else float(secs)
        self.rid = None if rid is None else int(rid)
        self.hits = 0    # matching visits (after the step/rid filters)
        self.fired = 0   # times the fault actually fired
        self.held_pages: list = []  # (allocator, pages) grabbed by exhaust

    _INT_KEYS = {"step", "times", "after", "rid"}
    _FLOAT_KEYS = {"prob", "sleep_s", "secs"}

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
        """Chainable: ``Chaos().rule("fail", "serve.step")``."""
        self.rules.append(Rule(action, point, **kw))
        return self

    def hit(self, point: str, step: Optional[int] = None, **kw):
        for r in self.rules:
            if not fnmatch.fnmatchcase(point, r.point):
                continue
            if r.step is not None and step != r.step:
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
            self._fire(r, point, step, kw)

    def release_exhausted(self):
        """Free every page grabbed by fired ``exhaust`` rules — the
        stand-in for other tenants' requests finishing.

        Refcount-aware: chaos drops only the ONE reference it took at
        ``exhaust`` time (decref, never a hard free), and skips pages
        some other path already recycled — so releasing the chaos
        tenant never frees a page a sibling request or the prefix cache
        still reads."""
        for r in self.rules:
            for alloc, pages in r.held_pages:
                held = [p for p in pages if alloc.is_held(p)]
                if held:
                    alloc.decref(held)
            r.held_pages.clear()

    def _fire(self, r: Rule, point: str, step, kw):
        if r.action in ("raise", "fail"):
            raise ChaosError(f"chaos: injected crash at {point} "
                             f"(step={step})")
        if r.action == "kill":
            raise ReplicaKilled(f"chaos: replica killed at {point} "
                                f"(step={step})")
        if r.action == "exhaust":
            # steal every free pool page (kw["pool"] is the serving
            # BlockAllocator); release_exhausted() gives them back
            alloc = kw.get("pool")
            if alloc is not None and alloc.num_free:
                pages = alloc.alloc(alloc.num_free, owner="__chaos__")
                if pages:
                    r.held_pages.append((alloc, pages))
            return
        if r.action == "hang":
            if r.secs is not None:
                _SLEEP(r.secs)
                return
            while True:  # stuck until something kills the process
                _SLEEP(_HANG_CHUNK_S)
        if r.action == "stall":
            _SLEEP(1.0 if r.secs is None else r.secs)


_ACTIVE: Optional[Chaos] = None


def chaos_point(name: str, step: Optional[int] = None, **kw):
    """Instrumentation hook.  A no-op (one None check) unless a schedule
    is installed via :func:`install` or :func:`installed`."""
    if _ACTIVE is None:
        return
    _ACTIVE.hit(name, step=step, **kw)


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
    """``with chaos.installed(Chaos(...)):`` — scoped injection."""
    c = chaos if isinstance(chaos, Chaos) else Chaos(chaos)
    prev = _ACTIVE
    install(c)
    try:
        yield c
    finally:
        if prev is not None:
            install(prev)
        else:
            uninstall()
