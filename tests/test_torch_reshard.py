"""The port's topology-elastic restore (``distributed/reshard.py``)
against the JAX package's.

The numpy slicing helpers must equal the reference's over a grid of
specs and mesh degrees.  Then a train state saved at dp2 x mp2 (4 gloo
ranks, ZeRO-1 over dp) is restored at mp2, at world size 1 and at dp2 x
sharding2: every rank's parameters and moments must equal its slice of
the gathered original (exact: only bytes move), and ``host_full`` must
raise on a leaf a peer partly holds (a ZeRO block, a tensor-parallel
shard) and hand back the whole leaf otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ckpt_workers as workers
from paddle_tpu.distributed import reshard as jreshard
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed import reshard as treshard
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.mesh import HybridTopology
from paddle_tpu_torch.models import llama as tllama

FIELDS = dict(jllama.PRESETS["llama-debug"])
TIMEOUT = 240.0

SPECS = [[], [None], [["dp"]], [["mp"], None], [None, ["mp"]],
         [["pp"], None, ["mp"]], [["pp"], ["mp"], None],
         [["dp", "mp"], None], [["pp"], ["dp"], None, ["mp"]]]
MESHES = [{"dp": 1, "pp": 1, "mp": 1}, {"dp": 2, "pp": 1, "mp": 2},
          {"dp": 4, "pp": 2, "mp": 1}, {"dp": 2, "pp": 2, "mp": 2}]


def _shape(spec):
    return (8, 4, 8, 4)[:max(1, len(spec))]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    str(v) for v in m.values()))
def test_numpy_helpers_equal_the_reference(mesh):
    for spec in SPECS:
        shape = _shape(spec)
        full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(
            shape)
        for name in ("shard_counts",):
            assert getattr(treshard, name)(spec, mesh, len(shape)) == \
                getattr(jreshard, name)(spec, mesh, len(shape))
        assert treshard.shard_shape(shape, spec, mesh) == \
            jreshard.shard_shape(shape, spec, mesh)
        coords = list(treshard.mesh_coords_iter(mesh))
        assert coords == list(jreshard.mesh_coords_iter(mesh))
        for c in coords:
            assert treshard.slice_for_shard(shape, spec, mesh, c) == \
                jreshard.slice_for_shard(shape, spec, mesh, c)
        t, j = treshard.reslice(full, spec, mesh), \
            jreshard.reslice(full, spec, mesh)
        assert t.keys() == j.keys()
        assert all(np.array_equal(t[k], j[k]) for k in t)
        np.testing.assert_array_equal(
            treshard.gather_full(t, shape, spec, mesh), full)
        assert treshard.spec_to_json(treshard.spec_from_json(spec)) == \
            jreshard.spec_to_json(jreshard.spec_from_json(spec))


def test_spec_round_trip_and_errors_match():
    for spec in (("pp", None, "mp"), ("mp", None), (None,),
                 (("dp", "mp"), None)):
        js = treshard.spec_to_json(spec)
        assert js == jreshard.spec_to_json(spec)
        assert treshard.spec_from_json(js) == spec
    for m in (treshard, jreshard):
        with pytest.raises(ValueError, match="evenly sharded"):
            m.slice_for_shard((6,), [["mp"]], {"mp": 4}, {"mp": 0})
        with pytest.raises(ValueError, match="more entries"):
            m.shard_counts([None, None], {}, 1)


def test_host_full_raises_on_a_leaf_a_peer_holds():
    topo = HybridTopology()          # a world of one: nothing is split
    t = torch.arange(6.0).reshape(2, 3)
    got = treshard.host_full(t, ("mp", None), topo)
    assert torch.equal(got, t) and got.data_ptr() != t.data_ptr()

    class Topo:                      # what a rank of dp2 x mp2 sees
        dims = {"dp": 2, "pp": 1, "sharding": 1, "sp": 1, "mp": 2}

    with pytest.raises(ValueError, match=r"\(6/12 elements addressable\)"):
        treshard.host_full(t, ("mp", None), Topo)
    with pytest.raises(ValueError, match="peer processes"):
        treshard.host_full(t, (None, "dp"), Topo)
    assert torch.equal(treshard.host_full(t, (None, None), Topo), t)


def test_rng_bundle_round_trip_replays_the_stream():
    torch.manual_seed(11)
    torch.rand(3)
    bundle = treshard.rng_bundle()
    a = torch.rand(5)
    torch.manual_seed(99)
    treshard.apply_rng_bundle(bundle)
    assert torch.equal(torch.rand(5), a)
    import json
    assert json.loads(json.dumps(bundle)) == bundle


def test_manifest_state_replays_the_data_cursor_and_guards_versions():
    class Loader:
        def __init__(self):
            self.pos = 0

        def state_dict(self):
            return {"pos": self.pos}

        def load_state_dict(self, d):
            self.pos = d["pos"]

    src = Loader()
    src.pos = 17
    extra = treshard.manifest_extra(data=src, rng=True)
    assert extra["data"] == {"pos": 17} and extra["topology"][
        "world_size"] == 1
    dst = Loader()
    from paddle_tpu_torch.distributed import fault_tolerance as tft
    man = dict(extra, framework_version=tft._framework_version())
    assert treshard.apply_manifest_state(man, data=dst, rng=True) == \
        {"data": True, "rng": True}
    assert dst.pos == 17
    man["framework_version"] = "paddle_tpu_torch 0.0.0 (torch 0.0)"
    with pytest.raises(tft.VersionSkewError):
        treshard.apply_manifest_state(man, rng=True)
    assert treshard.apply_manifest_state(
        man, rng=True, allow_version_skew=True)["rng"]


def _np_params():
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, fused_blocks="off",
                              **FIELDS)
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))


def _batches(n=2, B=8, S=16):
    rng = np.random.default_rng(4)
    V = FIELDS["vocab_size"]
    return [{"input_ids": rng.integers(0, V, (B, S)).astype(np.int64),
             "labels": rng.integers(0, V, (B, S)).astype(np.int64)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reshard") / "ck")
    full = spawn(workers.save_world, 4,
                 (FIELDS, _np_params(), _batches(), {"dp": 2, "mp": 2},
                  root), device="cpu", timeout=TIMEOUT)
    for other in full[1:]:           # every rank gathered the same state
        assert other.keys() == full[0].keys()
        assert all(np.array_equal(other[k], full[0][k]) for k in other
                   if isinstance(other[k], np.ndarray))
    return root, full[0]


def _spec_json(path):
    spec = treshard._flat_specs(tllama.param_specs(
        tllama.LlamaConfig(**FIELDS)))[path]
    return treshard.spec_to_json(spec)


@pytest.mark.parametrize("plan_kw,world", [({"mp": 2}, 2), ({}, 1),
                                           ({"dp": 2, "sharding": 2}, 4)],
                         ids=["mp2", "ws1", "dp2xsharding2"])
def test_restore_resharded_gives_every_rank_its_slice(saved, plan_kw,
                                                       world):
    root, full = saved
    if world == 1:
        from paddle_tpu_torch.distributed.mesh import set_topology
        threads = torch.get_num_threads()
        try:
            ranks = [workers.restore_world(FIELDS, plan_kw, root)]
        finally:
            set_topology(None)
            torch.set_num_threads(threads)
    else:
        ranks = spawn(workers.restore_world, world, (FIELDS, plan_kw, root),
                      device="cpu", timeout=TIMEOUT)
    for r in ranks:
        assert r["step"] == 2
        dims, coords = r["dims"], r["coords"]
        for key, got in r["params"].items():
            want = full[f"params/{key}"]
            sl = treshard.slice_for_shard(want.shape, _spec_json(key),
                                          dims, coords)
            np.testing.assert_array_equal(got, want[sl], err_msg=key)
        for key, got in r["moments"].items():
            path, _, name = key.rpartition("/")
            want = full[f"opt_state/{key}"]
            if np.ndim(want) == 0:
                assert got == want, key
                continue
            sl = treshard.slice_for_shard(want.shape, _spec_json(path),
                                          dims, coords)
            np.testing.assert_array_equal(got, want[sl], err_msg=key)
            # this rank's ZeRO block is its piece of the gathered moment
            d = r["zero"][path]
            blk = r["blocks"][key]
            if d is None:
                np.testing.assert_array_equal(blk, got)
            else:
                n = dims[r["zero_axis"]]
                k = coords[r["zero_axis"]]
                size = got.shape[d] // n
                np.testing.assert_array_equal(
                    blk, np.take(got, range(k * size, (k + 1) * size),
                                 axis=d))
        if world == 1:
            assert r["raised"] is None
            for key, v in r["local"].items():
                np.testing.assert_array_equal(v, full[key], err_msg=key)
        else:
            assert r["raised"] and "peer processes" in r["raised"]
