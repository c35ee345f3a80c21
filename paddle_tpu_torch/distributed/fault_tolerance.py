"""Fault tolerance: crash-consistent checkpoint commits, preemption
handling, bounded retries (the port of
``paddle_tpu/distributed/fault_tolerance.py``).

Commit protocol
    A save writes into a ``*.ptq-tmp`` sibling, fsyncs every payload
    file, records a manifest (file list + sizes + CRC32s + step +
    framework version) written atomically inside the temp dir, then
    publishes with a single atomic ``os.replace`` of the directory. The
    commit point IS the rename: readers (``is_committed`` /
    ``committed_steps`` / ``verify_dir``) only ever see directories that
    carry a complete manifest, so a kill at any instant leaves either
    the previous committed state or the new one — never a torn mix.
    The manifest's JSON schema is the reference's, so a directory either
    package commits passes the other's ``verify_dir``.

Preemption
    :class:`PreemptionHandler` turns SIGTERM/SIGINT into a latched flag;
    :class:`CheckpointManager` checks it at step boundaries, cuts a
    final synchronous checkpoint, and exits with ``RELAUNCH_EXIT_CODE``
    (101) so ``fleet.elastic.ElasticJob`` respawns the gang without
    burning its restart budget.

Retries
    :func:`retry_with_backoff` — bounded attempts, exponential backoff,
    seeded jitter, injectable sleep/clock.

Backends: ``"orbax"`` (the reference's name, kept) selects
``distributed.checkpoint``, the port's counterpart of the orbax backend
(asynchronous saves on a writer thread); ``"pickle"`` selects
``framework.io`` (always synchronous).  Both hold torch tensors.  A
save whose tensors do not fit on the disk is refused before anything
is written, with a message naming the bytes.

Telemetry lands in the profiler metrics registry (``ckpt_save_seconds``,
``ckpt_bytes_total``, ``ckpt_restore_fallback_total``...) and in
:func:`summary_lines`, the "Checkpoints" block.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..testing.chaos import chaos_point

__all__ = [
    "RELAUNCH_EXIT_CODE", "MANIFEST_NAME", "TMP_SUFFIX", "OLD_SUFFIX",
    "CheckpointCorruptionError", "VersionSkewError", "write_manifest",
    "read_manifest", "is_committed", "verify_dir", "commit_dir",
    "recover_dir", "step_dir_name", "committed_steps",
    "latest_committed_step", "prune_steps", "pin_step", "unpin_step",
    "pinned_steps", "backoff_delays", "retry_with_backoff",
    "PreemptionHandler", "CheckpointManager", "record_save",
    "record_restore", "record_fallback", "summary_lines", "stats",
    "reset_stats", "tree_bytes", "check_space",
]

# fleet.elastic.RELAUNCH_EXIT_CODE — "checkpoint saved, relaunch me for
# free". Duplicated (not imported) so this module stays import-light;
# equality is asserted by tests/test_torch_fault_tolerance.py.
RELAUNCH_EXIT_CODE = 101

__version__ = "0.1.0"

MANIFEST_NAME = "ptq_manifest.json"
TMP_SUFFIX = ".ptq-tmp"
OLD_SUFFIX = ".ptq-old"

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint directory failed manifest verification."""


class VersionSkewError(RuntimeError):
    """A checkpoint's recorded framework version differs from the
    running one while version-sensitive state (per-rank RNG streams) is
    being restored. RNG algorithms are allowed to change between
    versions, so a silent restore could fork the dropout/data-aug
    streams; pass ``allow_version_skew=True`` to restore anyway."""


# ---------------------------------------------------------------------------
# durability primitives
# ---------------------------------------------------------------------------

def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    # directory fsync makes the rename itself durable; some filesystems
    # (and all of CI's tmpfs variants) refuse — durability is then the
    # mount's problem, not a correctness one
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _crc32(path: str, chunk: int = 1 << 20) -> int:
    c = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            c = zlib.crc32(block, c)
    return c & 0xFFFFFFFF


def _payload_files(dirpath: str):
    """(relpath, abspath) for every file under dirpath, manifest excluded."""
    for base, _dirs, files in os.walk(dirpath):
        for fn in files:
            p = os.path.join(base, fn)
            rel = os.path.relpath(p, dirpath)
            if rel == MANIFEST_NAME:
                continue
            yield rel, p


def _framework_version() -> str:
    """The port and the torch build it runs on (torch's generator
    algorithms are what an RNG restore depends on)."""
    import torch
    return f"paddle_tpu_torch {__version__} (torch {torch.__version__})"


def tree_bytes(tree) -> int:
    """Bytes of the tensors (and numpy arrays) in a state tree: what a
    save writes, within the container format's few KiB."""
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return int(tree.numel() * tree.element_size())
    if hasattr(tree, "nbytes") and hasattr(tree, "dtype"):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def check_space(dirpath: str, nbytes: int, margin: int = 64 << 20):
    """Refuse a save of ``nbytes`` up front when the filesystem holding
    ``dirpath`` has less room (``margin`` spare for the container and
    the manifest): an ``OSError`` naming the bytes, never a shrunk or
    half-written checkpoint."""
    d = dirpath
    while d and not os.path.isdir(d):
        d = os.path.dirname(d)
    free = shutil.disk_usage(d or ".").free
    if free < nbytes + margin:
        raise OSError(
            f"checkpoint of {nbytes} bytes does not fit under {dirpath!r}: "
            f"{free} bytes free on its filesystem (needs {nbytes + margin} "
            f"with the {margin}-byte margin); refusing the save")


# ---------------------------------------------------------------------------
# manifest + commit
# ---------------------------------------------------------------------------

def write_manifest(dirpath: str, extra: Optional[dict] = None,
                   fsync: bool = True) -> dict:
    """Record every payload file's size+CRC32, fsync payloads, then write
    the manifest atomically (tmp + fsync + replace) inside ``dirpath``."""
    files = []
    total = 0
    for rel, p in sorted(_payload_files(dirpath)):
        st = os.stat(p)
        files.append({"path": rel, "bytes": st.st_size, "crc32": _crc32(p)})
        total += st.st_size
        if fsync:
            _fsync_file(p)
    man = {"format": 1, "framework_version": _framework_version(),
           "bytes_total": total, "files": files}
    if extra:
        man.update(extra)
    mpath = os.path.join(dirpath, MANIFEST_NAME)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, mpath)
    if fsync:
        _fsync_dir(dirpath)
    return man


def read_manifest(dirpath: str) -> Optional[dict]:
    """The manifest dict, or None when absent/unreadable (uncommitted)."""
    mpath = os.path.join(dirpath, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    return man if isinstance(man, dict) and "files" in man else None


def is_committed(dirpath: str) -> bool:
    """True iff ``dirpath`` is a checkpoint that finished its commit."""
    return os.path.isdir(dirpath) and read_manifest(dirpath) is not None


def verify_dir(dirpath: str, checksums: bool = True) -> dict:
    """Check every manifest entry (presence, size, CRC32); returns the
    manifest or raises :class:`CheckpointCorruptionError`."""
    man = read_manifest(dirpath)
    if man is None:
        raise CheckpointCorruptionError(
            f"checkpoint {dirpath!r} has no commit manifest "
            f"({MANIFEST_NAME}): the save never committed")
    for ent in man["files"]:
        p = os.path.join(dirpath, ent["path"])
        if not os.path.isfile(p):
            raise CheckpointCorruptionError(
                f"checkpoint {dirpath!r} is missing {ent['path']!r}")
        size = os.path.getsize(p)
        if size != ent["bytes"]:
            raise CheckpointCorruptionError(
                f"checkpoint {dirpath!r}: {ent['path']!r} is {size} bytes, "
                f"manifest says {ent['bytes']} (truncated write?)")
        if checksums and _crc32(p) != ent["crc32"]:
            raise CheckpointCorruptionError(
                f"checkpoint {dirpath!r}: {ent['path']!r} fails its CRC32 "
                f"(bit rot or torn write)")
    return man


def commit_dir(tmp_dir: str, final_dir: str, *, overwrite: bool = True,
               extra: Optional[dict] = None) -> dict:
    """Publish ``tmp_dir`` at ``final_dir`` crash-consistently.

    Order: manifest into tmp (durable) -> move any existing final aside
    -> atomic rename tmp->final (THE commit point) -> drop the old copy.
    A kill between any two steps leaves a state :func:`recover_dir` maps
    back to exactly one committed checkpoint. Under FLAGS_tpu_watchdog
    the whole protocol runs inside the ``ckpt.commit`` phase (a hung
    fsync on a dying disk produces a stack dump + incident within
    FLAGS_tpu_watchdog_ckpt_commit seconds).
    """
    from ..runtime import watchdog as _watchdog
    with _watchdog.phase("ckpt.commit"):
        man = write_manifest(tmp_dir, extra=extra)
        chaos_point("ft.commit.swap", step=(extra or {}).get("step"),
                    path=final_dir)
        old = final_dir + OLD_SUFFIX
        if os.path.exists(final_dir):
            if not overwrite:
                raise FileExistsError(final_dir)
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(final_dir, old)
        os.replace(tmp_dir, final_dir)
        _fsync_dir(os.path.dirname(final_dir) or ".")
        if os.path.exists(old):
            shutil.rmtree(old, ignore_errors=True)
    return man


def recover_dir(path: str) -> str:
    """Resolve ``path`` to its committed incarnation after any crash.

    - final committed: it wins; stray tmp/old copies are dropped.
    - final absent/uncommitted, tmp committed: the crash hit between the
      old copy moving aside and the publish rename — the temp copy is
      fully durable, so roll the commit forward.
    - otherwise, old copy present: roll back to it.
    """
    tmp, old = path + TMP_SUFFIX, path + OLD_SUFFIX
    if is_committed(path):
        for stray in (tmp, old):
            if os.path.exists(stray):
                shutil.rmtree(stray, ignore_errors=True)
        return path
    if is_committed(tmp):
        if os.path.exists(path):  # uncommitted husk loses to durable tmp
            shutil.rmtree(path)
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")
        if os.path.exists(old):
            shutil.rmtree(old, ignore_errors=True)
        return path
    if is_committed(old):
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(old, path)
        _fsync_dir(os.path.dirname(path) or ".")
        return path
    if os.path.exists(path):
        raise CheckpointCorruptionError(
            f"checkpoint {path!r} exists but never committed (no "
            f"{MANIFEST_NAME}) and no recoverable copy is adjacent")
    raise FileNotFoundError(f"no committed checkpoint at {path!r}")


# ---------------------------------------------------------------------------
# step-directory layout (shared by both backends)
# ---------------------------------------------------------------------------

def step_dir_name(step: int) -> str:
    return f"step_{step:08d}"


def _parse_step(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def committed_steps(root: str) -> List[int]:
    """Ascending steps whose directories finished their commit."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        s = _parse_step(d)
        if s is not None and is_committed(os.path.join(root, d)):
            out.append(s)
    return sorted(out)


def latest_committed_step(root: str) -> Optional[int]:
    steps = committed_steps(root)
    return steps[-1] if steps else None


# keep-anchor registry: steps an in-flight rewind or corruption
# fallback could still target. CheckpointManager.restore pins every step
# it successfully verifies+loads (the "last verified good" anchor), and
# prune_steps refuses to delete a pinned step even when newer saves push
# it out of the keep window.
_PINNED: Dict[str, set] = {}
_PINNED_LOCK = threading.Lock()


def pin_step(root: str, step: int):
    """Protect ``root/step_N`` from :func:`prune_steps` until unpinned."""
    with _PINNED_LOCK:
        _PINNED.setdefault(os.path.abspath(root), set()).add(int(step))


def unpin_step(root: str, step: Optional[int] = None):
    """Drop one pin (or every pin under ``root`` when step is None)."""
    with _PINNED_LOCK:
        pins = _PINNED.get(os.path.abspath(root))
        if pins is None:
            return
        if step is None:
            pins.clear()
        else:
            pins.discard(int(step))


def pinned_steps(root: str) -> set:
    with _PINNED_LOCK:
        return set(_PINNED.get(os.path.abspath(root), ()))


def prune_steps(root: str, keep: int,
                inflight: Iterable[int] = ()) -> List[int]:
    """Drop old committed steps, keeping the newest ``keep`` (0 = keep
    all). Never touches the latest committed step, pinned steps
    (:func:`pin_step` — the rewind/fallback keep-anchor), steps an async
    save is still writing, or their temp dirs; stale crash-leftover temp
    dirs ARE swept. Returns the steps removed."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        return []
    inflight = set(inflight)
    pinned = pinned_steps(root)
    removed = []
    steps = committed_steps(root)
    last = steps[-1] if steps else None
    victims = steps[:-keep] if keep else []
    for s in victims:
        if s in inflight or s == last or s in pinned:
            continue
        shutil.rmtree(os.path.join(root, step_dir_name(s)),
                      ignore_errors=True)
        removed.append(s)
    for d in os.listdir(root):
        base, sep, _rest = d.partition(TMP_SUFFIX)
        if not sep:
            continue
        s = _parse_step(base)
        if s is not None and s in inflight:
            continue  # an async save is still streaming into it
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    return removed


# ---------------------------------------------------------------------------
# bounded retries with exponential backoff + jitter
# ---------------------------------------------------------------------------

def backoff_delays(attempts: int, base: float = 0.05, factor: float = 2.0,
                   max_delay: float = 2.0, jitter: float = 0.25,
                   rng=None):
    """Yield the ``attempts - 1`` sleeps between attempts. Jitter scales
    each delay by [1, 1+jitter) drawn from ``rng`` (seed it for
    deterministic schedules in tests)."""
    if rng is None:
        import random
        rng = random.Random()
    d = base
    for _ in range(max(0, attempts - 1)):
        j = 1.0 + jitter * rng.random() if jitter else 1.0
        yield min(d, max_delay) * j
        d *= factor


def retry_with_backoff(fn: Callable[[], Any], *,
                       retryable: Tuple[type, ...] = (ConnectionError,
                                                     OSError),
                       give_up: Tuple[type, ...] = (),
                       attempts: int = 4, base_delay: float = 0.05,
                       factor: float = 2.0, max_delay: float = 2.0,
                       jitter: float = 0.25, sleep=time.sleep, rng=None,
                       on_retry: Optional[Callable] = None,
                       describe: str = ""):
    """Call ``fn`` up to ``attempts`` times; transient failures
    (``retryable`` minus ``give_up``) back off exponentially with jitter
    before the next try, non-transient ones raise immediately.
    ``sleep``/``rng`` are injectable so tests assert real schedules
    without real waiting (the ``bench._init_device_with_retries``
    idiom). ``on_retry(attempt, exc, delay)`` observes each backoff."""
    delays = backoff_delays(attempts, base=base_delay, factor=factor,
                            max_delay=max_delay, jitter=jitter, rng=rng)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except give_up:
            raise
        except retryable as e:
            delay = next(delays, None)
            if delay is None:
                raise
            if on_retry is not None:
                on_retry(attempt, e, delay)
            _bump("retries")
            sleep(delay)


# ---------------------------------------------------------------------------
# telemetry (metrics registry + Profiler "Checkpoints" section)
# ---------------------------------------------------------------------------

def _new_stats() -> Dict[str, Any]:
    return {"saves": 0, "bytes": 0, "last_save_s": 0.0, "last_step": None,
            "restores": 0, "fallbacks": 0, "retries": 0,
            "preemption_armed": False, "preemption_requested": False,
            "preempt_exits": 0}


_STATS = _new_stats()
_STATS_LOCK = threading.Lock()


def _bump(key: str, amount=1):
    with _STATS_LOCK:
        _STATS[key] += amount


def _metrics():
    from ..profiler import metrics
    return metrics


def record_save(seconds: float, bytes_total: int,
                step: Optional[int] = None):
    with _STATS_LOCK:
        _STATS["saves"] += 1
        _STATS["bytes"] += bytes_total
        _STATS["last_save_s"] = seconds
        if step is not None:
            _STATS["last_step"] = step
    m = _metrics()
    if not m.enabled():
        return
    m.histogram("ckpt_save_seconds",
                "Checkpoint save+commit wall time").observe(seconds)
    m.counter("ckpt_bytes_total",
              "Bytes committed to checkpoints").inc(bytes_total)
    m.counter("ckpt_saves_total", "Committed checkpoint saves").inc()
    if step is not None:
        m.gauge("ckpt_last_committed_step",
                "Newest committed checkpoint step").set(step)


def record_restore(step: Optional[int] = None):
    with _STATS_LOCK:
        _STATS["restores"] += 1
    m = _metrics()
    if m.enabled():
        m.counter("ckpt_restores_total", "Checkpoint restores").inc()


def record_fallback(step: Optional[int] = None):
    """A committed-looking step was skipped during restore (corrupt or
    unreadable); the restore fell back to an older one."""
    with _STATS_LOCK:
        _STATS["fallbacks"] += 1
    m = _metrics()
    if m.enabled():
        m.counter("ckpt_restore_fallback_total",
                  "Restore attempts that skipped a corrupt/uncommitted "
                  "step and fell back to an older one").inc()


def stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_stats():
    with _STATS_LOCK:
        _STATS.clear()
        _STATS.update(_new_stats())


def summary_lines() -> list:
    """The "Checkpoints" block of ``Profiler.summary_table()``."""
    s = stats()
    mib = s["bytes"] / (1 << 20)
    lines = ["Checkpoints",
             f"  saves committed: {s['saves']}  ({mib:.1f} MiB total, "
             f"last {s['last_save_s'] * 1e3:.1f} ms)",
             f"  restores: {s['restores']}  "
             f"(corruption fallbacks: {s['fallbacks']})"]
    if s["last_step"] is not None:
        lines.append(f"  last committed step: {s['last_step']}")
    if s["retries"]:
        lines.append(f"  transient-error retries: {s['retries']}")
    if s["preemption_armed"]:
        state = "requested" if s["preemption_requested"] else "armed"
        lines.append(f"  preemption: {state}  "
                     f"(relaunch exits: {s['preempt_exits']})")
    return lines


# ---------------------------------------------------------------------------
# preemption handling
# ---------------------------------------------------------------------------

class PreemptionHandler:
    """Latch SIGTERM/SIGINT into a flag checked at step boundaries.

    The contract (fleet/elastic/manager.py's exit-101 protocol): on
    preemption notice, finish the current step, cut one final
    synchronous checkpoint, and exit ``RELAUNCH_EXIT_CODE`` so
    ``ElasticJob`` respawns the gang without consuming its restart
    budget. The signal handler itself only sets an Event — no I/O, no
    locks, async-signal-safe."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), *,
                 install: bool = True):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: Dict[int, Any] = {}
        self._installed = False
        if install:
            self.install()

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        with _STATS_LOCK:
            _STATS["preemption_armed"] = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        self._installed = False

    def _on_signal(self, signum, frame):
        self._event.set()
        with _STATS_LOCK:
            _STATS["preemption_requested"] = True

    def requested(self) -> bool:
        return self._event.is_set()

    def clear(self):
        self._event.clear()
        with _STATS_LOCK:
            _STATS["preemption_requested"] = False

    def exit_for_relaunch(self):
        """Exit asking the supervisor for a free relaunch."""
        _bump("preempt_exits")
        m = _metrics()
        if m.enabled():
            m.counter("ckpt_preempt_exits_total",
                      "Preemption exits requesting relaunch").inc()
        raise SystemExit(RELAUNCH_EXIT_CODE)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Save-every-N / keep-K / auto-resume over the commit protocol.

    Backends: ``"orbax"`` (async-capable, rides
    ``distributed.checkpoint``; the reference's name for its sharded
    backend), ``"pickle"`` (``framework.io``, always synchronous). Both
    lay out ``root/step_NNNNNNNN`` committed directories of torch
    tensors, so ``latest_step`` / ``restore`` semantics are identical.
    ``specs`` (``models.llama.param_specs(cfg)``, nested or flat by
    '/'-joined path) records each leaf's placement in the manifest, from
    which ``reshard.restore_resharded`` re-slices the state onto another
    topology.

    With ``preemption=True`` a :class:`PreemptionHandler` is armed and
    ``step_end`` honors it: final sync save, then ``SystemExit(101)``.

        mgr = CheckpointManager(root, save_interval_steps=50, keep=3)
        state, start = mgr.restore(target)   # (None, 0) on first launch
        for step in range(start, STEPS):
            state = train(state)
            mgr.step_end(step + 1, state)
    """

    def __init__(self, root: str, *, save_interval_steps: int = 1,
                 keep: int = 3, backend: str = "orbax", sync: bool = False,
                 preemption=False, state_file: str = "state.pdz",
                 track_rng: bool = True, specs: Optional[dict] = None):
        if backend not in ("orbax", "pickle"):
            raise ValueError(f"backend must be 'orbax' or 'pickle', "
                             f"got {backend!r}")
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.save_interval_steps = int(save_interval_steps)
        self.keep = int(keep)
        self.backend = backend
        self.sync = bool(sync) or backend == "pickle"
        self.state_file = state_file
        self.track_rng = bool(track_rng)
        self.specs = specs
        self._data_obj = None
        self._owns_handler = preemption is True
        if preemption is True:
            self._preempt: Optional[PreemptionHandler] = PreemptionHandler()
        elif isinstance(preemption, PreemptionHandler):
            self._preempt = preemption
        else:
            self._preempt = None

    # -- data-pipeline tracking --------------------------------------------
    def attach_data(self, obj) -> "CheckpointManager":
        """Track a DataLoader / DistributedBatchSampler (anything with
        ``state_dict``/``load_state_dict``). Every save then embeds its
        state in the checkpoint manifest, and ``restore`` replays it —
        sample-exact resume, valid across a dp resize because sampler
        offsets are defined in global sample order."""
        if obj is not None and not hasattr(obj, "state_dict"):
            raise TypeError(
                f"attach_data needs an object with state_dict/"
                f"load_state_dict, got {type(obj).__name__}")
        self._data_obj = obj
        return self

    def _manifest_extra(self, step: int, state: Any = None) -> dict:
        """The topology/sharding/RNG/data-state block every committed
        checkpoint carries (reshard.manifest_extra; failures degrade to
        a bare {"step"} manifest rather than failing the save)."""
        extra: Dict[str, Any] = {"step": step}
        try:
            from .reshard import manifest_extra
            extra.update(manifest_extra(data=self._data_obj,
                                        rng=self.track_rng, state=state,
                                        specs=self.specs))
        except Exception as e:  # noqa: BLE001 — save must still commit
            import sys as _sys
            _sys.stderr.write(
                f"checkpoint: manifest extras unavailable ({e}); "
                f"saving step {step} without topology/rng state\n")
        return extra

    # -- queries ------------------------------------------------------------
    @property
    def preemption_handler(self) -> Optional[PreemptionHandler]:
        return self._preempt

    def preempted(self) -> bool:
        return self._preempt is not None and self._preempt.requested()

    def all_steps(self) -> List[int]:
        return committed_steps(self.root)

    def latest_step(self) -> Optional[int]:
        return latest_committed_step(self.root)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval_steps == 0

    # -- save / restore -----------------------------------------------------
    def save(self, step: int, state: Any, *, sync: Optional[bool] = None):
        """Commit ``state`` as step ``step`` and prune old steps. The
        manifest carries the topology/sharding/RNG/data-pipeline block
        (:meth:`attach_data`, ``track_rng``) so the checkpoint restores
        onto a different world size with sample-exact data resume."""
        sync = self.sync if sync is None else sync
        extra = self._manifest_extra(step, state)
        if self.backend == "orbax":
            from . import checkpoint as dckpt
            dckpt.save_step(self.root, state, step, keep=self.keep,
                            sync=sync, extra=extra)
            return
        final = os.path.join(self.root, step_dir_name(step))
        tmp = final + TMP_SUFFIX
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        check_space(self.root, tree_bytes(state))
        t0 = time.perf_counter()
        os.makedirs(tmp)
        from ..framework.io import save as fsave
        chaos_point("ckpt.save.pre", step=step, path=final)
        fsave(state, os.path.join(tmp, self.state_file))
        chaos_point("ckpt.commit.pre", step=step, path=final)
        man = commit_dir(tmp, final, extra=extra)
        chaos_point("ckpt.commit.post", step=step, path=final)
        record_save(time.perf_counter() - t0, man["bytes_total"], step=step)
        prune_steps(self.root, self.keep)

    def _apply_manifest_state(self, step: int, *, apply_data: bool,
                              apply_rng: bool, allow_version_skew: bool):
        man = read_manifest(os.path.join(self.root, step_dir_name(step)))
        if man is None:
            return
        from .reshard import apply_manifest_state
        apply_manifest_state(
            man, data=self._data_obj if apply_data else None,
            rng=apply_rng and self.track_rng,
            allow_version_skew=allow_version_skew)

    def restore(self, target: Any = None, step: Optional[int] = None, *,
                apply_data: bool = True, apply_rng: bool = True,
                allow_version_skew: bool = False) -> Tuple[Any, int]:
        """(state, step) from the newest loadable committed step —
        falling back past corrupt ones — or (None, 0) when the run is
        fresh. ``target`` (orbax backend: a tree of tensors) places the
        loaded leaves on its leaves' devices and holds their shapes and
        dtypes; ``reshard.restore_resharded`` re-slices onto another
        topology.

        The restored step is pinned (:func:`pin_step`) as the
        last-verified-good anchor, so pruning can never delete the
        checkpoint an in-flight rewind or corruption fallback targets.
        When the manifest carries data-pipeline / RNG state it is
        replayed into the attached loader and the framework RNG
        (``apply_data``/``apply_rng``); RNG restore refuses a
        framework-version skew unless ``allow_version_skew=True``."""
        got: Optional[int] = None
        state: Any = None
        if self.backend == "orbax":
            from . import checkpoint as dckpt
            try:
                state, got = dckpt.load_step(self.root, target, step=step)
            except FileNotFoundError:
                return None, 0
        else:
            candidates = [step] if step is not None else \
                list(reversed(self.all_steps()))
            for s in candidates:
                d = os.path.join(self.root, step_dir_name(s))
                try:
                    verify_dir(d)
                    from ..framework.io import load as fload
                    state = fload(os.path.join(d, self.state_file))
                except (CheckpointCorruptionError, RuntimeError, OSError):
                    if step is not None:
                        raise
                    record_fallback(s)
                    continue
                got = s
                break
            if got is None:
                return None, 0
            record_restore(got)
        self._apply_manifest_state(
            got, apply_data=apply_data, apply_rng=apply_rng,
            allow_version_skew=allow_version_skew)
        # one anchor per root: the newest verified-good step
        unpin_step(self.root)
        pin_step(self.root, got)
        return state, got

    # -- train-loop hook ----------------------------------------------------
    def step_end(self, step: int, state: Any) -> bool:
        """Call once per completed step. Saves on the interval; on a
        pending preemption, cuts a final synchronous checkpoint and
        exits ``RELAUNCH_EXIT_CODE`` (raises SystemExit)."""
        if self.preempted():
            self.save(step, state, sync=True)
            self.wait()
            self._preempt.exit_for_relaunch()
        if self.should_save(step):
            self.save(step, state)
            return True
        return False

    def wait(self):
        """Block until every in-flight async save has committed."""
        if self.backend == "orbax":
            from . import checkpoint as dckpt
            dckpt.wait_until_finished()

    def close(self):
        self.wait()
        if self._owns_handler and self._preempt is not None:
            self._preempt.uninstall()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
