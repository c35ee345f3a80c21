"""Step-directory checkpoints of torch state trees, synchronous or on a
writer thread (the port of ``paddle_tpu/distributed/checkpoint.py``,
the reference's orbax backend).

A checkpoint is one committed directory holding ``state.pt``, the tree
as ``framework.io`` writes it (torch tensors, bf16 kept as bf16), under
the crash-consistency protocol of ``fault_tolerance``: the save streams
into a ``*.ptq-tmp`` sibling, a fsynced manifest records sizes, CRC32s
and the step, and one atomic directory rename publishes it.  Readers
(``latest_step`` / ``load`` / ``load_train_state``) only ever see
committed directories, verify the manifest before reading, and fall
back to the previous committed step on corruption.  Pruning never
removes the newest committed step and never touches a step a save is
still writing.

``sync=False`` hands the write to a writer thread.  Torch updates
parameters and optimizer moments in place (a JAX array never changes),
so the caller's thread first takes a *snapshot*: a device copy of every
tensor, queued on the current stream after the step that produced it,
so the next step's in-place update is ordered after the copy and no
host sync is needed.  The writer thread then copies the snapshot to
the host on a stream of its own (after an event recorded behind the
copies) and writes it; ``wait_until_finished`` joins the writers and
raises the first failure.  The snapshot costs one copy of the state in
device memory while the write is in flight.

The reference's orbax restores onto any mesh through the target's
shardings; here re-slicing onto another topology is
``reshard.restore_resharded``'s, and ``load(..., target=)`` places the
loaded tensors on the target's devices, holding shapes and dtypes.
"""
from __future__ import annotations

import os
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from . import fault_tolerance as ft
from ..testing.chaos import chaos_point

__all__ = ["save", "load", "save_step", "load_step", "save_train_state",
           "load_train_state", "latest_step", "wait_until_finished",
           "snapshot", "host_copy", "CheckpointCorruptionError",
           "STATE_FILE"]

CheckpointCorruptionError = ft.CheckpointCorruptionError

STATE_FILE = "state.pt"

# async commit machinery: each sync=False save runs on a writer thread;
# wait_until_finished() joins them all, and pruning consults _INFLIGHT
# so a streaming step is never swept
_ASYNC_LOCK = threading.Lock()
_ASYNC_THREADS: List[threading.Thread] = []
_ASYNC_ERRORS: List[BaseException] = []
_INFLIGHT: Dict[str, Set[int]] = {}  # root -> steps still streaming


def wait_until_finished():
    """Block until every async save (sync=False) has committed. Raises
    the first deferred commit failure, if any."""
    while True:
        with _ASYNC_LOCK:
            live = [t for t in _ASYNC_THREADS if t.is_alive()]
            if not live:
                _ASYNC_THREADS.clear()
                errs = list(_ASYNC_ERRORS)
                _ASYNC_ERRORS.clear()
                break
        for t in live:
            t.join()
    if errs:
        raise errs[0]


# ---------------------------------------------------------------------------
# snapshots: what an in-place optimizer step cannot alter
# ---------------------------------------------------------------------------

def _map(tree, fn):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


class Snapshot:
    """Device copies of a state tree's tensors, ordered on the stream
    that produced them, plus the event behind the copies (CUDA)."""

    __slots__ = ("tree", "event", "device")

    def __init__(self, tree, event, device):
        self.tree, self.event, self.device = tree, event, device


def snapshot(tree) -> Snapshot:
    """Copy every tensor of ``tree`` on its device, queued on the
    current stream (after the work that produced it, before any later
    in-place update), without a host sync."""
    devs = []

    def copy(t):
        devs.append(t.device)
        return t.detach().clone()

    out = _map(tree, copy)
    cuda = next((d for d in devs if d.type == "cuda"), None)
    event = None
    if cuda is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda))
    return Snapshot(out, event, cuda)


_SIDE: Dict[Any, Any] = {}


def host_copy(snap) -> Any:
    """The snapshot's tree on the host.  CUDA copies run on a stream of
    their own that waits only for the snapshot's event, so they never
    queue behind later work (or a hung kernel) on the stream that took
    it."""
    if not isinstance(snap, Snapshot):
        return _map(snap, lambda t: t.detach().to("cpu", copy=True))
    if snap.event is None:
        return snap.tree
    side = _SIDE.get(snap.device)
    if side is None:
        side = _SIDE.setdefault(snap.device,
                                torch.cuda.Stream(device=snap.device))
    with torch.cuda.stream(side):
        side.wait_event(snap.event)
        return _map(snap.tree, lambda t: t.cpu())


# ---------------------------------------------------------------------------
# commit plumbing
# ---------------------------------------------------------------------------

def _finalize(tmp: str, final: str, t0: float, step: Optional[int],
              root: Optional[str], keep: Optional[int],
              extra: Optional[dict] = None):
    """Publish a durable tmp dir: manifest -> atomic rename -> metrics ->
    inflight bookkeeping -> pruning. Runs inline for sync saves, on the
    writer thread for async ones (so pruning naturally waits on them)."""
    try:
        chaos_point("ckpt.commit.pre", step=step, path=final)
        if extra is None:
            extra = {"step": step} if step is not None else None
        man = ft.commit_dir(tmp, final, overwrite=True, extra=extra)
        chaos_point("ckpt.commit.post", step=step, path=final)
        ft.record_save(time.perf_counter() - t0, man["bytes_total"],
                       step=step)
    finally:
        if root is not None and step is not None:
            with _ASYNC_LOCK:
                _INFLIGHT.get(root, set()).discard(step)
    if root is not None and keep is not None:
        with _ASYNC_LOCK:
            inflight = set(_INFLIGHT.get(root, set()))
        ft.prune_steps(root, keep, inflight=inflight)


def _write(tmp: str, tree) -> None:
    from ..framework.io import save as fsave
    os.makedirs(tmp, exist_ok=True)
    fsave(tree, os.path.join(tmp, STATE_FILE))


def _save_impl(final: str, tree: Any, *, overwrite: bool, sync: bool,
               step: Optional[int] = None, root: Optional[str] = None,
               keep: Optional[int] = None,
               extra: Optional[dict] = None) -> None:
    if os.path.exists(final) and not overwrite:
        raise FileExistsError(final)
    os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
    tmp = final + ft.TMP_SUFFIX
    if os.path.exists(tmp):
        shutil.rmtree(tmp)  # stale leftover from a crashed save
    ft.check_space(os.path.dirname(final) or ".", ft.tree_bytes(
        tree.tree if isinstance(tree, Snapshot) else tree))
    if root is not None and step is not None:
        with _ASYNC_LOCK:
            _INFLIGHT.setdefault(root, set()).add(step)
    chaos_point("ckpt.save.pre", step=step, path=final)
    t0 = time.perf_counter()
    os.makedirs(tmp)
    if sync:
        try:
            _write(tmp, tree)
        except BaseException:
            if root is not None and step is not None:
                with _ASYNC_LOCK:
                    _INFLIGHT.get(root, set()).discard(step)
            raise
        _finalize(tmp, final, t0, step, root, keep, extra)
        return
    snap = tree if isinstance(tree, Snapshot) else snapshot(tree)

    def _write_and_commit():
        try:
            _write(tmp, host_copy(snap))
            _finalize(tmp, final, t0, step, root, keep, extra)
        except BaseException as e:  # surfaced by wait_until_finished()
            if root is not None and step is not None:
                with _ASYNC_LOCK:
                    _INFLIGHT.get(root, set()).discard(step)
            with _ASYNC_LOCK:
                _ASYNC_ERRORS.append(e)

    th = threading.Thread(target=_write_and_commit, daemon=True,
                          name="ptq-ckpt-commit")
    with _ASYNC_LOCK:
        _ASYNC_THREADS.append(th)
    th.start()


def save(path: str, tree: Any, *, overwrite: bool = True,
         sync: bool = True) -> None:
    """Save a state tree as one checkpoint directory. Crash-consistent:
    the previous checkpoint at ``path`` survives until the replacement
    has fully committed."""
    _save_impl(os.path.abspath(path), tree, overwrite=overwrite, sync=sync)


def _place_like(tree, target):
    """``tree``'s tensors on ``target``'s devices; shapes and dtypes
    must agree."""
    if torch.is_tensor(target):
        if not torch.is_tensor(tree):
            raise ValueError(f"checkpoint holds {type(tree).__name__} "
                             f"where the target holds a tensor")
        if tree.shape != target.shape or tree.dtype != target.dtype:
            raise ValueError(
                f"checkpoint leaf {tuple(tree.shape)} {tree.dtype} does "
                f"not match the target's {tuple(target.shape)} "
                f"{target.dtype}")
        return tree.to(target.device)
    if isinstance(target, dict):
        missing = sorted(set(target) - set(tree))
        if missing:
            raise ValueError(f"checkpoint lacks keys {missing}")
        return {k: (_place_like(tree[k], target[k]) if k in target
                    else tree[k]) for k in tree}
    return tree


def load(path: str, target: Any = None, *, verify: bool = True) -> Any:
    """Restore a checkpoint (CPU tensors, or on ``target``'s devices).

    Only committed checkpoints are visible: a half-written directory is
    recovered to the last committed copy or rejected, and ``verify=True``
    checks the manifest (sizes + CRC32s) before any deserialization."""
    from ..framework.io import load as fload
    path = ft.recover_dir(os.path.abspath(path))
    if verify:
        ft.verify_dir(path)
    state = fload(os.path.join(path, STATE_FILE))
    return state if target is None else _place_like(state, target)


# ---------------------------------------------------------------------------
# step-directory train-state API
# ---------------------------------------------------------------------------

def latest_step(root: str) -> Optional[int]:
    """Newest COMMITTED step under ``root`` — never a half-written
    ``step_*`` directory."""
    return ft.latest_committed_step(root)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), ft.step_dir_name(step))


def save_step(root: str, state: Any, step: int, *, keep: int = 3,
              sync: bool = True, extra: Optional[dict] = None) -> str:
    """Save a state tree under root/step_N with the commit protocol,
    pruning old committed steps (keep=0 keeps all). Pruning skips steps
    still streaming in async saves and never removes the newest
    committed step. ``extra`` replaces the default ``{"step"}`` manifest
    extras (topology/RNG/data state from CheckpointManager)."""
    root_abs = os.path.abspath(root)
    d = _step_dir(root, step)
    _save_impl(d, state, overwrite=True, sync=sync, step=step,
               root=root_abs, keep=keep, extra=extra)
    return d


def load_step(root: str, target: Any = None, step: Optional[int] = None,
              ) -> Tuple[Any, int]:
    """(state, step) from ``root`` — the requested step, or the newest
    committed one, falling back past corrupt steps (each fallback
    increments ``ckpt_restore_fallback_total``)."""
    if step is not None:
        state = load(_step_dir(root, step), target)
        ft.record_restore(step)
        return state, step
    steps = ft.committed_steps(root)
    if not steps:
        raise FileNotFoundError(
            f"no committed step_* checkpoints under {root}")
    for s in reversed(steps):
        try:
            state = load(_step_dir(root, s), target)
        except (ft.CheckpointCorruptionError, FileNotFoundError,
                RuntimeError) as e:
            sys.stderr.write(
                f"checkpoint: step {s} under {root} failed verification "
                f"({e}); falling back to the previous committed step\n")
            ft.record_fallback(s)
            continue
        ft.record_restore(s)
        return state, s
    raise ft.CheckpointCorruptionError(
        f"every committed step under {root} failed verification "
        f"(tried {list(reversed(steps))})")


def _opt_tree(opt_state):
    """A ``ZeroOptimizer``'s moments by parameter path (this rank's
    blocks); any other tree as it is."""
    return opt_state.state_tree() if hasattr(opt_state, "state_tree") \
        else opt_state


def save_train_state(root: str, params: Any, opt_state: Any, step: int,
                     *, keep: int = 3, sync: bool = True) -> str:
    """Save (params, opt_state) under root/step_N, pruning old steps.
    ``opt_state`` is a tree, or a ``distributed.zero.ZeroOptimizer``
    (its ``state_tree()``: moments and step counters by parameter
    path)."""
    return save_step(root, {"params": params,
                            "opt_state": _opt_tree(opt_state)},
                     step, keep=keep, sync=sync)


def load_train_state(root: str, params_target: Any = None,
                     opt_state_target: Any = None,
                     step: Optional[int] = None
                     ) -> Tuple[Any, Any, int]:
    """Restore (params, opt_state, step) from root (latest committed
    step unless given), onto the targets' devices.  A ``ZeroOptimizer``
    target takes the moments in place (``load_state_tree``) and is what
    comes back as ``opt_state``."""
    if (params_target is None) != (opt_state_target is None):
        raise ValueError(
            "pass both params_target and opt_state_target (the restore "
            "target must cover the whole saved state) or neither")
    target = None
    if params_target is not None:
        target = {"params": params_target,
                  "opt_state": _opt_tree(opt_state_target)}
    state, got = load_step(root, target, step=step)
    opt = state["opt_state"]
    if hasattr(opt_state_target, "load_state_tree"):
        opt_state_target.load_state_tree(opt)
        opt = opt_state_target
    return state["params"], opt, got
