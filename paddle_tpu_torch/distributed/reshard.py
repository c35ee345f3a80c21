"""Topology-elastic checkpoint restore (the port of
``paddle_tpu/distributed/reshard.py``).

Every committed checkpoint carries a topology/sharding block in its
crash-consistency manifest (``fault_tolerance.write_manifest extra=``):
the world size and axis degrees, each leaf's partition spec (from
``models.llama.param_specs``), per-rank RNG streams (torch's CPU and
CUDA generators) and the data-pipeline cursor.  Restoring onto a
*different* ``(dp, pp, sharding, sp, mp)`` topology then needs no
resharding service: the full logical tensors are read on the host, and
each rank cuts its own slice by the saved spec re-bound to the
*current* topology's coordinates (``place``), so no rank holds more
than its piece on the device.

The slicing/gathering math is pure numpy (:func:`slice_for_shard`,
:func:`reslice`, :func:`gather_full`), copied from the reference, so it
is testable without ranks and reusable by hosts reassembling per-rank
shard files.

A torch tensor carries no placement, so the port's helpers take it
beside the tensor: ``host_full(leaf, spec, topo)`` raises on a leaf a
peer partly holds; ``gather_train_state`` (collective) and
``local_train_state`` (none: the failure path) build the full host
state of a train step's params and ``ZeroOptimizer``, keyed by the
parameter paths of ``param_specs``.

Typical elastic resume, new world size included::

    state, step = reshard.restore_resharded(root, data=loader, rng=True)
    params, opt = init_fn(params=state["params"])
    opt.load_state_tree(state["opt_state"])
"""
from __future__ import annotations

import itertools
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "spec_to_json", "spec_from_json", "shard_counts", "shard_shape",
    "slice_for_shard", "mesh_coords_iter", "reslice", "gather_full",
    "topology_block", "sharding_specs", "rng_bundle", "apply_rng_bundle",
    "manifest_extra", "apply_manifest_state", "place", "place_tree",
    "restore_resharded", "host_full", "gather_train_state",
    "local_train_state", "train_state_specs",
]


# ---------------------------------------------------------------------------
# sharding-spec serialization
# ---------------------------------------------------------------------------

def _axes_of(entry) -> List[str]:
    if entry is None:
        return []
    if isinstance(entry, (list, tuple)):
        return [str(a) for a in entry]
    return [str(entry)]


def spec_to_json(spec) -> List[Optional[List[str]]]:
    """PartitionSpec (or any per-dim sequence of axis names) -> JSON:
    one entry per array dim, ``None`` (replicated) or the list of mesh
    axes that dim shards over."""
    out: List[Optional[List[str]]] = []
    for entry in tuple(spec):
        axes = _axes_of(entry)
        out.append(axes if axes else None)
    return out


def spec_from_json(obj) -> Tuple:
    """Inverse of :func:`spec_to_json`: the port's spec form, one axis
    name, tuple of names or None a dimension (``models.llama
    .param_specs``'s)."""
    entries = []
    for e in obj or []:
        if not e:
            entries.append(None)
        elif len(e) == 1:
            entries.append(e[0])
        else:
            entries.append(tuple(e))
    return tuple(entries)


# ---------------------------------------------------------------------------
# host-side slicing math (pure numpy — no devices involved)
# ---------------------------------------------------------------------------

def _pad_spec(spec_json, ndim: int) -> List[Optional[List[str]]]:
    s = list(spec_json or [])
    if len(s) > ndim:
        raise ValueError(
            f"sharding spec {spec_json!r} has more entries than array "
            f"dims ({ndim})")
    return s + [None] * (ndim - len(s))


def shard_counts(spec_json, dims: Dict[str, int], ndim: int) -> List[int]:
    """Number of shards along each array dim: the product of the mesh
    degrees of the axes that dim shards over (1 for replicated dims and
    axes the mesh does not carry)."""
    counts = []
    for axes in _pad_spec(spec_json, ndim):
        n = 1
        for a in (axes or []):
            n *= int(dims.get(a, 1))
        counts.append(n)
    return counts


def slice_for_shard(shape, spec_json, dims: Dict[str, int],
                    coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The index slice of the full array owned by the device at mesh
    coordinates ``coords`` (axis name -> coordinate). Multi-axis dims
    compose row-major over the axis tuple — GSPMD's layout convention,
    and the port's (``HybridTopology.axis_index``)."""
    out = []
    for size, axes in zip(tuple(shape), _pad_spec(spec_json, len(shape))):
        n = 1
        for a in (axes or []):
            n *= int(dims.get(a, 1))
        if n > 1 and size % n:
            raise ValueError(
                f"dim of size {size} does not divide into {n} shards "
                f"(axes {axes!r} over mesh {dims!r}); elastic restore "
                f"needs evenly sharded dims")
        i = 0
        for a in (axes or []):
            i = i * int(dims.get(a, 1)) + int(coords.get(a, 0))
        step = size // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def shard_shape(shape, spec_json, dims: Dict[str, int]) -> Tuple[int, ...]:
    """Per-shard shape under ``spec_json`` on a mesh of ``dims``."""
    sls = slice_for_shard(shape, spec_json, dims, {})
    return tuple(sl.stop - sl.start for sl in sls)


def mesh_coords_iter(dims: Dict[str, int]):
    """Every mesh coordinate dict of a mesh with the given axis degrees."""
    axes = list(dims)
    for combo in itertools.product(*[range(int(dims[a])) for a in axes]):
        yield dict(zip(axes, combo))


def _coords_key(coords: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted(coords.items()))


def reslice(full, spec_json, dims: Dict[str, int]
            ) -> Dict[Tuple[Tuple[str, int], ...], np.ndarray]:
    """Cut a full host array into its per-device shards: coords-key ->
    ndarray. Replicated dims produce identical copies, exactly like the
    device placement would."""
    full = np.asarray(full)
    return {
        _coords_key(c): full[slice_for_shard(full.shape, spec_json, dims, c)]
        for c in mesh_coords_iter(dims)
    }


def gather_full(shards: Dict[Tuple[Tuple[str, int], ...], np.ndarray],
                shape, spec_json, dims: Dict[str, int],
                dtype=None) -> np.ndarray:
    """Reassemble the full logical array from per-device shards (inverse
    of :func:`reslice`; replicated copies overwrite idempotently)."""
    if dtype is None:
        dtype = next(iter(shards.values())).dtype
    out = np.empty(tuple(shape), dtype=dtype)
    for key, piece in shards.items():
        coords = dict(key)
        sl = slice_for_shard(shape, spec_json, dims, coords)
        expect = tuple(s.stop - s.start for s in sl)
        if tuple(piece.shape) != expect:
            raise ValueError(
                f"shard at {coords!r} has shape {tuple(piece.shape)}, "
                f"spec {spec_json!r} over mesh {dims!r} expects {expect}")
        out[sl] = piece
    return out


# ---------------------------------------------------------------------------
# state trees: '/'-joined paths, and each leaf's spec
# ---------------------------------------------------------------------------

def _flat(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the tree's order; dict keys and list indices
    joined by '/'."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix.rstrip("/"), tree)]
    out = []
    for k, v in items:
        out.extend(_flat(v, f"{prefix}{k}/"))
    return out


def _unflat(tree, fn, prefix: str = ""):
    """``tree`` with every leaf ``x`` at path ``p`` replaced by
    ``fn(p, x)``."""
    if isinstance(tree, dict):
        return {k: _unflat(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflat(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix.rstrip("/"), tree)


def _flat_specs(specs) -> Dict[str, Any]:
    """``param_specs``' nested form (or a flat one) by '/'-joined path."""
    if specs is None:
        return {}
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in _flat_specs(v).items()})
        else:
            out[k] = v
    return out


def _is_array(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, np.ndarray)


def _leaf_spec(path: str, leaf, specs: Dict[str, Any]):
    """The spec of a train-state leaf: ``params/<p>`` takes the
    parameter's, ``opt_state/<p>/<name>`` too when it has the
    parameter's rank (a moment), a bare ``<p>`` its own; a per-step
    scalar none."""
    if path in specs:
        return specs[path]
    head, _, rest = path.partition("/")
    if head == "params" and rest in specs:
        return specs[rest]
    if head == "opt_state":
        p, _, _name = rest.rpartition("/")
        if p in specs and getattr(leaf, "ndim", 0) > 0:
            return specs[p]
    return None


def train_state_specs(opt_state) -> Dict[str, Tuple]:
    """Flat specs of a train state ``{"params", "opt_state"}`` held by
    ``opt_state`` (a ``ZeroOptimizer``): the parameters' placements and
    the moments' (with ZeRO's axis on the dimension it splits)."""
    out = {f"params/{p}": tuple(s) for p, s in opt_state.specs.items()}
    state = opt_state.state_tree()
    for p, s in opt_state.zero_specs().items():
        for name, v in state.get(p, {}).items():
            if torch.is_tensor(v) and v.dim() > 0:
                out[f"opt_state/{p}/{name}"] = s
    return out


# ---------------------------------------------------------------------------
# manifest block: topology + per-param specs + RNG + data cursor
# ---------------------------------------------------------------------------

def topology_block() -> dict:
    """The save-time topology: launch world size plus — when a topology
    has been set up — its axis degrees.  Reads the registered topology
    (never creates one from inside a checkpoint save)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    block: Dict[str, Any] = {"world_size": int(world), "rank": int(rank)}
    from .mesh import get_topology
    topo = get_topology(create=False)
    if topo is not None:
        block["mesh"] = {k: int(v) for k, v in topo.dims.items()}
        block["axes"] = list(topo.AXES)
        block["devices"] = int(topo.world_size())
    return block


def sharding_specs(state, specs=None) -> Optional[dict]:
    """Per-leaf ``{path: {shape, dtype, spec}}`` for every tensor leaf of
    ``state`` with a spec in ``specs`` (``param_specs``, nested or flat;
    ``params/<p>`` and ``opt_state/<p>/<moment>`` take ``<p>``'s)."""
    if state is None or not specs:
        return None
    flat = _flat_specs(specs)
    out: Dict[str, Any] = {}
    for path, leaf in _flat(state):
        if not _is_array(leaf):
            continue
        spec = _leaf_spec(path, leaf, flat)
        if spec is None:
            continue
        dtype = str(leaf.dtype).replace("torch.", "")
        out[path] = {"shape": [int(d) for d in leaf.shape],
                     "dtype": dtype, "spec": spec_to_json(spec)}
    return out or None


def rng_bundle() -> dict:
    """JSON-able snapshot of this rank's RNG streams: torch's CPU
    generator and, once CUDA is up, every device's generator."""
    bundle = {"rank": int(os.environ.get("PADDLE_TRAINER_ID", "0")),
              "cpu": [int(x) for x in torch.get_rng_state().tolist()]}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        bundle["cuda"] = [[int(x) for x in s.tolist()]
                          for s in torch.cuda.get_rng_state_all()]
    return bundle


def apply_rng_bundle(bundle: dict):
    """Restore the streams captured by :func:`rng_bundle`."""
    cpu = bundle.get("cpu")
    if cpu is not None:
        torch.set_rng_state(torch.tensor(cpu, dtype=torch.uint8))
    cuda = bundle.get("cuda")
    if cuda and torch.cuda.is_available():
        n = min(len(cuda), torch.cuda.device_count())
        torch.cuda.set_rng_state_all(
            [torch.tensor(s, dtype=torch.uint8) for s in cuda[:n]])


def manifest_extra(data=None, rng: bool = True, state=None,
                   specs=None) -> dict:
    """The elastic-resume block CheckpointManager embeds in every commit
    manifest: topology, per-leaf shardings (when ``state`` and ``specs``
    are given), per-rank RNG streams, and the data-pipeline cursor
    (``data`` must expose ``state_dict``)."""
    extra: Dict[str, Any] = {"topology": topology_block()}
    if state is not None:
        try:
            sh = sharding_specs(state, specs)
        except Exception:  # noqa: BLE001 — specs are advisory
            sh = None
        if sh:
            extra["shardings"] = sh
    if rng:
        extra["rng"] = rng_bundle()
    if data is not None:
        extra["data"] = data.state_dict()
    return extra


def apply_manifest_state(man: dict, *, data=None, rng: bool = False,
                         allow_version_skew: bool = False) -> dict:
    """Replay the manifest's data-pipeline cursor into ``data`` and (when
    ``rng=True``) its RNG streams into this process.

    RNG stream restore is version-sensitive (generator algorithms may
    change), so a framework-version mismatch between the checkpoint and
    this process raises :class:`~.fault_tolerance.VersionSkewError`
    unless ``allow_version_skew=True``. Returns ``{"data": bool, "rng":
    bool}`` saying what was actually applied."""
    applied = {"data": False, "rng": False}
    if data is not None and isinstance(man.get("data"), dict):
        if not hasattr(data, "load_state_dict"):
            raise TypeError(
                f"cannot replay data-pipeline state into "
                f"{type(data).__name__}: no load_state_dict")
        data.load_state_dict(man["data"])
        applied["data"] = True
    bundle = man.get("rng")
    if rng and isinstance(bundle, dict):
        from . import fault_tolerance as ft
        saved = man.get("framework_version")
        cur = ft._framework_version()
        if (saved not in (None, "unknown") and cur != "unknown"
                and saved != cur and not allow_version_skew):
            raise ft.VersionSkewError(
                f"checkpoint was written by {saved} but this process "
                f"runs {cur}: restoring per-rank RNG streams across "
                f"versions can silently fork the dropout/data-aug "
                f"streams. Pass allow_version_skew=True to restore "
                f"anyway, or restore with apply_rng=False to reseed "
                f"fresh.")
        apply_rng_bundle(bundle)
        applied["rng"] = True
    return applied


# ---------------------------------------------------------------------------
# full host state from this rank's tensors
# ---------------------------------------------------------------------------

def _dims(topo) -> Dict[str, int]:
    if topo is None:
        from .mesh import get_topology
        topo = get_topology(create=False)
    return dict(topo.dims) if topo is not None else {}


def host_full(leaf, spec=None, topo=None):
    """The full host tensor of ``leaf``, this rank's tensor placed by
    ``spec`` over ``topo`` (default: the registered topology), using
    ONLY this rank's data — no collective, so it is safe on the failure
    path where peers may already be dead.  A leaf that no axis of more
    than one rank splits (replicated, or split over an axis of one)
    comes back as a host copy; a leaf whose data partly lives on a PEER
    rank raises ``ValueError`` — that state is physically unrecoverable
    from one rank."""
    spec_json = spec_to_json(spec) if spec else []
    ndim = len(getattr(leaf, "shape", ()))
    counts = shard_counts(spec_json, _dims(topo), ndim)
    n = int(np.prod(counts)) if counts else 1
    if n > 1:
        local = int(np.prod(leaf.shape)) if ndim else 1
        full = [int(d) * c for d, c in zip(leaf.shape, counts)]
        raise ValueError(
            f"array of shape {tuple(full)} is not reconstructible from "
            f"this process's shards ({local}/{local * n} elements "
            f"addressable): its sharding places data on peer processes")
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def local_train_state(params, opt_state, topo=None) -> dict:
    """``{"params", "opt_state"}`` on the host from this rank's tensors
    alone (``host_full`` on every leaf): raises ``ValueError`` when a
    peer holds part of a leaf (tensor parallelism, pipeline stages,
    ZeRO-sharded moments)."""
    topo = topo if topo is not None else opt_state.topo
    specs = train_state_specs(opt_state)
    state = {"params": params, "opt_state": opt_state.state_tree()}
    return _unflat(state, lambda p, x: host_full(x, specs.get(p), topo)
                   if torch.is_tensor(x) else x)


def _gather(t: torch.Tensor, spec, topo, virtual_pp=None) -> torch.Tensor:
    from . import collective as C
    v = virtual_pp or 1
    t = t.detach()
    for dim, axis in enumerate(spec or ()):
        if axis and topo.dims[axis] > 1:
            t = C._all_gather(t.contiguous(), topo.group(axis), dim=dim)
            n = topo.dims[axis]
            if axis == "pp" and v > 1:
                # position (d, c) holds global chunk c * pp + d
                t = t[_chunk_rows(t.shape[0], n, v,
                                  [(g % n) * v + g // n
                                   for g in range(n * v)])]
    return t.to("cpu", copy=True)


def gather_train_state(params, opt_state, topo=None, *,
                       virtual_pp=None) -> dict:
    """``{"params", "opt_state"}`` with every leaf whole on the host: the
    moments' ZeRO blocks gathered over the zero axis, then every leaf
    over the axes its parameter splits over (collective: every rank
    calls it, and every rank gets the whole state).  Layers in global
    order (the interleaved layout of ``virtual_pp`` undone)."""
    topo = topo if topo is not None else opt_state.topo
    specs = opt_state.specs
    flat = dict(_flat(params))
    out_params = _unflat(params, lambda p, x: _gather(x, specs[p], topo,
                                                       virtual_pp))
    out_opt = {}
    for p, st in opt_state.full_state_tree().items():
        out_opt[p] = {k: (_gather(v, specs[p], topo, virtual_pp)
                          if torch.is_tensor(v)
                          and v.dim() == flat[p].dim() else
                          (v.detach().to("cpu", copy=True)
                           if torch.is_tensor(v) else v))
                      for k, v in st.items()}
    return {"params": out_params, "opt_state": out_opt}


# ---------------------------------------------------------------------------
# placement onto the current topology
# ---------------------------------------------------------------------------

def _chunk_rows(L: int, pp: int, v: int, chunks):
    """The layer rows of the given global chunks of an interleaved
    layout (``pp * v`` chunks of ``L / (pp * v)`` layers), in order."""
    if L % (pp * v):
        raise ValueError(f"{L} layers do not split into pp={pp} x "
                         f"virtual_pp={v} chunks")
    n = L // (pp * v)
    return [r for g in chunks for r in range(g * n, (g + 1) * n)]


def _topology(topo=None):
    if topo is not None:
        return topo
    from .mesh import get_topology
    return get_topology()


def place(host_array, spec_json, topo=None, *, device=None,
          virtual_pp=None) -> torch.Tensor:
    """Host array -> this rank's slice of it on ``device`` (the card
    unless the caller names another), cut by the saved spec re-bound to
    ``topo``'s degrees and this rank's coordinates (axes the topology
    does not split fall back to replicated).  Under ``virtual_pp`` = v
    > 1 a ``pp`` dimension takes the interleaved layout's chunks."""
    from ..device import resolve_device
    topo = _topology(topo)
    dev = resolve_device(device)
    t = host_array if torch.is_tensor(host_array) \
        else torch.from_numpy(np.ascontiguousarray(host_array))
    spec_json = spec_to_json(spec_json or ())
    v = virtual_pp or 1
    sls = list(slice_for_shard(tuple(t.shape), spec_json, topo.dims,
                               topo.coords))
    padded = _pad_spec(spec_json, t.dim())
    if v > 1 and padded and padded[0] and "pp" in padded[0] \
            and topo.dims["pp"] > 1:
        n, k = topo.dims["pp"], topo.coords["pp"]
        t = t[_chunk_rows(t.shape[0], n, v, [c * n + k for c in range(v)])]
        sls[0] = slice(None)
    return t[tuple(sls)].to(dev, copy=True,
                            memory_format=torch.contiguous_format)


def place_tree(host_tree, manifest: Optional[dict] = None, *, topo=None,
               specs: Optional[dict] = None, device=None,
               virtual_pp=None):
    """Re-place a host-loaded state tree onto the current topology using
    the per-leaf specs saved in ``manifest["shardings"]`` (or an
    explicit flat ``specs`` map of JSON specs). Leaves without a
    recorded spec are placed whole when they are tensors (a per-step
    scalar stays on the host), left untouched otherwise."""
    if specs is None:
        specs = {p: e["spec"] for p, e in
                 ((manifest or {}).get("shardings") or {}).items()}
    topo = _topology(topo)

    def put(path, leaf):
        if not _is_array(leaf):
            return leaf
        spec = specs.get(path)
        if spec is None and getattr(leaf, "ndim", 0) == 0:
            return leaf
        return place(leaf, spec or [], topo, device=device,
                     virtual_pp=virtual_pp)

    return _unflat(host_tree, put)


def restore_resharded(root: str, step: Optional[int] = None, *,
                      state_file: str = "state.pdz", topo=None,
                      device=None, virtual_pp=None, data=None,
                      rng: bool = False,
                      allow_version_skew: bool = False) -> Tuple[Any, int]:
    """Restore a committed ``root/step_N`` checkpoint written on ANY
    topology onto the current one: verify the manifest, read the full
    logical tensors on the host (the ``framework.io`` state file, or the
    ``distributed.checkpoint`` payload), then slice-and-place per the
    saved specs re-bound to this topology on ``device``.  Optionally
    replays the data-pipeline cursor (``data=loader``) and per-rank RNG
    streams (``rng=True``) from the manifest.

    Returns ``(state, step)``; ``(None, 0)`` when ``root`` holds no
    committed step. The restored step is pinned as the keep-anchor so
    pruning cannot delete it while it is still the rewind target."""
    from . import fault_tolerance as ft
    root = os.path.abspath(root)
    if step is None:
        step = ft.latest_committed_step(root)
        if step is None:
            return None, 0
    d = os.path.join(root, ft.step_dir_name(step))
    man = ft.verify_dir(d)
    spath = os.path.join(d, state_file)
    if os.path.isfile(spath):
        from ..framework.io import load as fload
        host_state = fload(spath)
    else:
        from . import checkpoint as dckpt
        host_state = dckpt.load(d, None, verify=False)  # verified above
    state = place_tree(host_state, man, topo=topo, device=device,
                       virtual_pp=virtual_pp)
    ft.record_restore(step)
    apply_manifest_state(man, data=data, rng=rng,
                         allow_version_skew=allow_version_skew)
    ft.unpin_step(root)
    ft.pin_step(root, step)
    return state, step
