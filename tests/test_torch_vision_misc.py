"""The rest of the vision stack on the CPU, held against the JAX
package on the same seeded inputs: the conv and pooling layers (the
reference's weights crossed over, keys and order equal), the detection
ops beyond the op sweep, ``geometric``'s message passing and
reindexing, ``nn.utils``, the transforms, the datasets (bit-equal
arrays), ``metric``, the hapi callbacks and ``amp.debugging``.
Tolerances: float outputs 1e-5 and gradients 1e-4 (f32), or as a test
states; integer outputs, indices and host-computed boxes equal up to
1e-6."""
import json
import warnings

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from torch_nn_cases import VISION, VISION_NAMES, check_layer

PKGS = (jpaddle, tpaddle)


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same(a, b, tol=1e-5):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, tol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind in "fc" or b.dtype.kind in "fc":
        np.testing.assert_allclose(a.astype(np.float32),
                                   b.astype(np.float32), rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(a, b)


def _both(fn, tol=1e-5):
    """fn(paddle) on both packages, the results held together."""
    want, got = (_np(fn(P)) for P in PKGS)
    _same(got, want, tol)
    return got


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("cls,args,kwargs,inputs,eval_,tol", VISION)
def test_layer_matches_the_reference(cls, args, kwargs, inputs, eval_, tol):
    check_layer(cls, args, kwargs, inputs, eval_, tol)


def test_every_conv_and_pooling_layer_has_a_case():
    import paddle_tpu_torch.nn.layer.conv as conv
    import paddle_tpu_torch.nn.layer.pooling as pool
    names = {n for n in dir(conv) if n[0] == "C" and "Conv" in n
             and not n.startswith("_")} | set(pool.__all__)
    assert names == set(VISION_NAMES)


# -- vision.ops beyond the sweep ----------------------------------------------

R = np.random.default_rng(7)
BOXES = np.concatenate([R.uniform(0, 20, (12, 2)),
                        R.uniform(0, 20, (12, 2)) + 25], 1).astype(np.float32)
SCORES = R.uniform(0, 1, (12,)).astype(np.float32)


def test_nms_padded_and_roi_layers():
    x = np.random.default_rng(3).standard_normal((1, 8, 12, 12)).astype(
        np.float32)

    def fn(P):
        idx, valid = P.vision.ops.nms_padded(P.to_tensor(BOXES),
                                             P.to_tensor(SCORES), 0.2, 8)
        xt, b = P.to_tensor(x), P.to_tensor(BOXES[:3] / 4)
        num = P.to_tensor(np.array([3]))
        return [idx, valid,
                P.vision.ops.RoIAlign(2, 0.5)(xt, b, num),
                P.vision.ops.RoIPool(2, 0.5)(xt, b, num),
                P.vision.ops.PSRoIPool(2, 0.5)(xt, b, num)]
    got = _both(fn)
    keep = _np(tpaddle.vision.ops.nms(tpaddle.to_tensor(BOXES), 0.2,
                                      scores=tpaddle.to_tensor(SCORES)))
    assert got[0][:got[1].sum()].tolist() == keep.tolist()


def test_box_coder_prior_box_yolo_box():
    prior = BOXES[:4]
    pvar = np.array([0.1, 0.1, 0.2, 0.2], np.float32)

    def fn(P):
        T = P.to_tensor
        enc = P.vision.ops.box_coder(T(prior), T(pvar), T(BOXES[4:7]))
        dec = P.vision.ops.box_coder(T(prior), T(pvar), enc,
                                     code_type="decode_center_size")
        boxes, var = P.vision.ops.prior_box(
            T(np.zeros((1, 3, 4, 5), np.float32)),
            T(np.zeros((1, 3, 32, 40), np.float32)), [4.0, 8.0], [9.0, 12.0],
            aspect_ratios=[2.0], flip=True, clip=True)
        head = np.random.default_rng(5).standard_normal(
            (2, 2 * (5 + 3), 4, 4)).astype(np.float32)
        yb = P.vision.ops.yolo_box(T(head), T(np.array([[64, 64], [32, 48]])),
                                   [10, 13, 16, 30], 3, 0.3, 16)
        return [enc, dec, boxes, var, yb[0], yb[1]]
    _both(fn, 1e-5)


def test_nms_families_and_proposals():
    rng = np.random.default_rng(11)
    bb = np.concatenate([rng.uniform(0, 10, (2, 10, 2)),
                         rng.uniform(0, 10, (2, 10, 2)) + 8], -1).astype(
        np.float32)
    sc = rng.uniform(0, 1, (2, 3, 10)).astype(np.float32)

    sc_rpn = rng.uniform(0, 1, (1, 3, 4, 4)).astype(np.float32)
    deltas = (rng.standard_normal((1, 12, 4, 4)) * 0.1).astype(np.float32)
    xy = rng.uniform(0, 30, (4, 4, 3, 2))
    anchors = np.concatenate([xy, xy + 10], -1).astype(np.float32)

    def fn(P):
        T = P.to_tensor
        mc = P.vision.ops.multiclass_nms(T(bb), T(sc), 0.2, nms_top_k=6,
                                         keep_top_k=5, nms_threshold=0.4,
                                         return_index=True)
        mx = P.vision.ops.matrix_nms(T(bb), T(sc), 0.2, 0.1, nms_top_k=6,
                                     keep_top_k=5, return_index=True)
        rois, restore, nums = P.vision.ops.distribute_fpn_proposals(
            T(bb.reshape(-1, 4) * 20), 2, 5, 4, 224,
            rois_num=T(np.array([12, 8])))
        gp = P.vision.ops.generate_proposals(
            T(sc_rpn), T(deltas), T(np.array([[40.0, 40.0]])), T(anchors),
            T(np.full(anchors.shape, 0.5, np.float32)), pre_nms_top_n=20,
            post_nms_top_n=6, return_rois_num=True)
        return list(mc) + list(mx) + list(rois) + [restore] + list(nums) \
            + list(gp)
    _both(fn)


def test_deform_conv2d_and_yolo_loss_gradients():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
    off = (rng.standard_normal((1, 2 * 2 * 9, 6, 6)) * 0.7).astype(np.float32)
    msk = rng.uniform(0, 1, (1, 2 * 9, 6, 6)).astype(np.float32)
    w = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
    head = rng.standard_normal((2, 2 * (5 + 3), 4, 4)).astype(np.float32)
    gt = np.array([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.5],
                    [0, 0, 0, 0]],
                   [[0.5, 0.5, 0.6, 0.6], [0.2, 0.8, 0.1, 0.1],
                    [0.9, 0.1, 0.05, 0.1]]], np.float32)
    lab = np.array([[1, 2, 0], [0, 1, 2]])

    def fn(P):
        ts = [P.to_tensor(a, stop_gradient=False) for a in (x, off, msk, w)]
        y = P.vision.ops.deform_conv2d(ts[0], ts[1], ts[3], padding=1,
                                       deformable_groups=2, groups=2,
                                       mask=ts[2])
        h = P.to_tensor(head, stop_gradient=False)
        loss = P.vision.ops.yolo_loss(h, P.to_tensor(gt), P.to_tensor(lab),
                                      [10, 13, 16, 30, 33, 23], [1, 2], 3,
                                      0.5, 16)
        (P.sum(y * y) + P.sum(loss)).backward()
        return [y, loss] + [t.grad for t in ts] + [h.grad]
    _both(fn, 1e-4)
    layer = tpaddle.vision.ops.DeformConv2D(4, 4, 3, padding=1,
                                            deformable_groups=2, groups=2)
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    out = layer(tpaddle.to_tensor(x), tpaddle.to_tensor(off),
                tpaddle.to_tensor(msk))
    assert out.shape == [1, 4, 6, 6]


# -- geometric ------------------------------------------------------------------

def test_message_passing_and_reindex():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    e = rng.standard_normal((7, 3)).astype(np.float32)
    src = np.array([0, 1, 2, 3, 4, 0, 2])
    dst = np.array([1, 2, 1, 0, 0, 1, 3])

    def fn(P):
        G = P.geometric
        xt = P.to_tensor(x, stop_gradient=False)
        et = P.to_tensor(e, stop_gradient=False)
        s, d = P.to_tensor(src), P.to_tensor(dst)
        outs = [G.send_u_recv(xt, s, d, r) for r in ("sum", "mean", "max")]
        outs.append(G.send_u_recv(xt, s, d, "min", out_size=4))
        outs += [G.send_ue_recv(xt, et, s, d, m, r) for m, r in
                 (("add", "sum"), ("mul", "mean"), ("sub", "max"))]
        outs += [G.send_uv(xt, xt, s, d, c) for c in ("add", "mul")]
        loss = None
        for o in outs:
            v = P.where(P.isfinite(o), o, P.zeros_like(o))
            loss = P.sum(v) if loss is None else loss + P.sum(v * v)
        loss.backward()
        nb, cnt = P.to_tensor(np.array([7, 3, 9, 3, 8])), \
            P.to_tensor(np.array([2, 3]))
        rg = G.reindex_graph(P.to_tensor(np.array([3, 9])), nb, cnt)
        rh = G.reindex_heter_graph(
            P.to_tensor(np.array([3, 9])), [nb, P.to_tensor(np.array([5, 3]))],
            [cnt, P.to_tensor(np.array([1, 1]))])
        colptr = P.to_tensor(np.array([0, 2, 5, 6]))
        row = P.to_tensor(np.array([1, 2, 0, 2, 1, 0]))
        sn = G.sample_neighbors(row, colptr, P.to_tensor(np.array([1, 0])),
                                eids=P.to_tensor(np.arange(10, 16)),
                                return_eids=True)
        return outs + [xt.grad, et.grad] + list(rg) + list(rh) + list(sn)
    _both(fn, 1e-4)
    np.random.seed(0)
    a = _np(tpaddle.geometric.sample_neighbors(
        tpaddle.to_tensor(np.arange(9)), tpaddle.to_tensor(np.array([0, 9])),
        tpaddle.to_tensor(np.array([0])), sample_size=4))
    np.random.seed(0)
    b = _np(jpaddle.geometric.sample_neighbors(
        jpaddle.to_tensor(np.arange(9)), jpaddle.to_tensor(np.array([0, 9])),
        jpaddle.to_tensor(np.array([0])), sample_size=4))
    _same(a, b)


# -- nn.utils ---------------------------------------------------------------------

def test_nn_utils():
    def fn(P):
        P.seed(0)
        lin = P.nn.Linear(3, 4)
        return lin
    jl, tl = fn(jpaddle), fn(tpaddle)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    vec = [P.nn.utils.parameters_to_vector(m.parameters())
           for P, m in ((jpaddle, jl), (tpaddle, tl))]
    _same(_np(vec[1]), _np(vec[0]))
    tpaddle.nn.utils.vector_to_parameters(vec[1] * 2, tl.parameters())
    _same(tl.weight.numpy(), 2 * np.asarray(jl.weight.numpy()))
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    for P, m in ((jpaddle, jl), (tpaddle, tl)):
        P.nn.utils.weight_norm(m, "weight", dim=1)
    assert list(tl.state_dict()) == list(jl.state_dict())
    _same(_np(tl(tpaddle.to_tensor(x))), _np(jl(jpaddle.to_tensor(x))))
    # the port's weight norm is differentiable in g and v
    y = tpaddle.sum(tl(tpaddle.to_tensor(x)))
    y.backward()
    assert tl.weight_g.grad is not None and tl.weight_v.grad is not None
    for P, m in ((jpaddle, jl), (tpaddle, tl)):
        P.nn.utils.remove_weight_norm(m)
    assert list(tl.state_dict()) == list(jl.state_dict())
    _same(tl.weight.numpy(), np.asarray(jl.weight.numpy()))
    sn = [P.nn.utils.spectral_norm(P.nn.Linear(3, 4), n_power_iterations=2)
          for P in PKGS]
    assert list(sn[1].state_dict()) == list(sn[0].state_dict())
    sn[1].set_state_dict({k: v.numpy() for k, v in sn[0].state_dict().items()})
    _same(_np(sn[1](tpaddle.to_tensor(x))), _np(sn[0](jpaddle.to_tensor(x))),
          1e-4)


# -- transforms -------------------------------------------------------------------

def test_transforms_match_the_reference():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (6, 8, 3)).astype(np.uint8)

    def fn(P):
        T = P.vision.transforms
        outs = [T.to_tensor(img),
                T.normalize(img.astype(np.float32), [1, 2, 3], [2, 2, 2],
                            data_format="HWC"),
                T.resize(img.astype(np.float32), (12, 16)),
                T.resize(img, 4, "nearest"),
                T.center_crop(img, 4), T.crop(img, 1, 2, 3, 4),
                T.hflip(img), T.vflip(img),
                T.pad(img, [1, 2], fill=3), T.pad(img, 2, padding_mode="reflect"),
                T.adjust_brightness(img, 1.3), T.adjust_contrast(img, 0.7),
                T.adjust_saturation(img, 0.5), T.adjust_hue(img, 0.1),
                T.to_grayscale(img), T.rotate(img, 30),
                T.affine(img, 10, (1, 2), 1.1, 5),
                T.Compose([T.CenterCrop(4), T.ToTensor(),
                           T.Normalize([0.5] * 3, [0.5] * 3)])(img),
                T.erase(img, 1, 1, 2, 3, 0)]
        np.random.seed(5)
        outs += [T.RandomCrop(4)(img), T.RandomHorizontalFlip(1.0)(img),
                 T.RandomResizedCrop(5)(img.astype(np.float32)),
                 T.ColorJitter(0.2, 0.2, 0.2, 0.05)(img),
                 T.RandomErasing(1.0)(T.to_tensor(img))]
        return outs
    # bilinear resizing is antialiased in both; only the enlarging calls
    # agree to rounding, so a shrink is held to 2 levels of uint8
    got = [_np(o) for o in fn(tpaddle)]
    want = [_np(o) for o in fn(jpaddle)]
    for k, (a, b) in enumerate(zip(got, want)):
        tol = 2.0 if k == 21 else 1e-4
        _same(a.astype(np.float32), b.astype(np.float32), tol)


# -- datasets ---------------------------------------------------------------------

def test_datasets_hold_the_references_bits(tmp_path):
    import paddle_tpu.vision.datasets as JD
    import paddle_tpu_torch.vision.datasets as TD
    pairs = [(JD.SyntheticImages(64, (3, 8, 8), 5, seed=3),
              TD.SyntheticImages(64, (3, 8, 8), 5, seed=3)),
             (JD.MNIST(mode="test", backend="synthetic"),
              TD.MNIST(mode="test", backend="synthetic")),
             (JD.FashionMNIST(backend="synthetic"),
              TD.FashionMNIST(backend="synthetic")),
             (JD.Cifar100(mode="test"), TD.Cifar100(mode="test")),
             (JD.Flowers(mode="test", backend="synthetic"),
              TD.Flowers(mode="test", backend="synthetic")),
             (JD.VOC2012(mode="test", backend="synthetic"),
              TD.VOC2012(mode="test", backend="synthetic"))]
    for j, t in pairs:
        assert len(j) == len(t)
        for k in (0, len(j) - 1):
            for a, b in zip(t[k], j[k]):
                np.testing.assert_array_equal(a, b)
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for k in range(2):
            np.save(tmp_path / c / f"{k}.npy",
                    np.full((1, 2, 2), k, np.float32))
    j, t = JD.DatasetFolder(str(tmp_path)), TD.DatasetFolder(str(tmp_path))
    assert t.classes == j.classes and t.samples == j.samples
    np.testing.assert_array_equal(t[3][0], j[3][0])
    assert t[3][1] == j[3][1]
    j, t = JD.ImageFolder(str(tmp_path)), TD.ImageFolder(str(tmp_path))
    assert t.samples == j.samples


# -- metric -----------------------------------------------------------------------

def test_metrics_match_the_reference():
    rng = np.random.default_rng(13)
    pred = rng.standard_normal((20, 6)).astype(np.float32)
    pred[3, :2] = 1.0                    # a tie within the top k
    lab = rng.integers(0, 6, (20, 1))
    prob = rng.uniform(0, 1, (20,)).astype(np.float32)
    blab = (rng.uniform(0, 1, 20) < 0.5).astype(np.int64)

    def fn(P):
        M = P.metric
        acc = M.Accuracy(topk=(1, 3))
        outs = [M.accuracy(P.to_tensor(pred), P.to_tensor(lab), k=2)]
        for part in (slice(0, 12), slice(12, 20)):
            c = acc.compute(P.to_tensor(pred[part]), P.to_tensor(lab[part]))
            outs.append(np.asarray(acc.update(c)))
        outs.append(np.asarray(acc.accumulate()))
        pr, rc, auc = M.Precision(), M.Recall(), M.Auc(num_thresholds=99)
        for m in (pr, rc, auc):
            m.update(prob, blab)
            outs.append(np.float32(m.accumulate()))
        assert acc.name() == ["acc_top1", "acc_top3"]
        return outs
    _both(fn)


# -- callbacks --------------------------------------------------------------------

def test_scalar_logger_writes_the_references_records(tmp_path):
    for P, d in ((jpaddle, "j"), (tpaddle, "t")):
        lg = P.hapi.callbacks.ScalarLogger(str(tmp_path / d), log_freq=2)
        lg.log(1, loss=0.5, acc=[0.25], name="x")
        for s in range(4):
            lg.on_train_batch_end(s, {"loss": float(s)})
        lg.on_train_end()
    read = [(tmp_path / d / "scalars.jsonl").read_text().splitlines()
            for d in "jt"]
    assert read[0] == read[1]
    assert json.loads(read[1][0]) == {"step": 1, "scalars": {
        "loss": 0.5, "acc": 0.25}}


def test_visualdl_and_early_stopping(tmp_path):
    cb = tpaddle.hapi.callbacks
    vdl = cb.VisualDL(str(tmp_path))
    vdl.on_train_batch_end(0, {"loss": 1.5, "acc": "n/a"})
    vdl.on_epoch_end(0, {"loss": [1.0], "eval_acc": 0.5})
    vdl.on_train_end()
    tags = [json.loads(line)["tag"] for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert tags == ["train/loss", "train_epoch/loss", "eval/acc"]

    class _M:
        stop_training = False
    es = cb.EarlyStopping(patience=1)
    es.set_model(_M())
    for ep, v in enumerate([1.0, 0.9, 0.95]):
        es.on_epoch_end(ep, {"loss": v})
    assert es.model.stop_training and es.best == 0.9


# -- amp.debugging ----------------------------------------------------------------

def test_tensor_checker_actions_and_window():
    dbg = tpaddle.amp.debugging
    from paddle_tpu_torch.profiler import numerics
    bad = tpaddle.to_tensor(np.array([1.0, np.nan, np.inf], np.float32))
    assert dbg.check_numerics(bad) is bad        # flag off: nothing
    try:
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            debug_mode=dbg.DebugMode.CHECK_NAN_INF_AND_ABORT))
        with pytest.raises(numerics.NonFiniteError, match="1 NaN, 1 Inf"):
            dbg.check_numerics(bad, "site_a")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            dbg.check_numerics(bad, "site_b", action="warn")
        assert any("site_b" in str(x.message) for x in w)
        dbg.clear_results()
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            debug_mode=dbg.DebugMode.CHECK_ALL, start_step=2, end_step=3))
        dbg.check_numerics(bad, "early")          # step 0: outside
        dbg.advance_step()
        dbg.advance_step()
        dbg.check_numerics(bad, "in_window")
        dbg.advance_step()
        dbg.check_numerics(bad, "late")
        assert [r["name"] for r in dbg.collect_results()] == ["in_window"]
        with pytest.raises(ValueError):
            dbg.check_numerics(bad, action="explode")
    finally:
        dbg.disable_tensor_checker()
        dbg.clear_results()
    assert not tpaddle.get_flags(["FLAGS_tpu_check_nan_inf"])[
        "FLAGS_tpu_check_nan_inf"]
