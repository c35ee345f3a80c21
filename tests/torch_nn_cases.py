"""The layer cases of ``tests/test_torch_nn.py`` and
``tests/test_torch_nn_norm_loss.py``: every ported layer built the same
way in both packages, the port taking the JAX layer's weights through
``set_state_dict`` of numpy arrays, both run on the same seeded input;
outputs, the gradients of ``Σ out * w`` w.r.t. the inputs and every
parameter, and the state the forward updates are compared (f32: outputs
1e-5, gradients 1e-4)."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.testing.op_cases import (  # noqa: F401
    f, i, n, probs, unpool_idx)

L = []


def layer(cls, *args, inputs, eval_=False, tol=1e-5, tag="", **kwargs):
    L.append(pytest.param(cls, args, kwargs, inputs, eval_, tol,
                          id=f"{cls}-{tag}" if tag else cls))


# common
layer("Linear", 4, 3, inputs=[f(2, 4)])
layer("Linear", 4, 3, inputs=[f(2, 5, 4)], tag="nobias", bias_attr=False)
layer("Identity", inputs=[f(2, 4)])
layer("Flatten", inputs=[f(2, 3, 4)])
layer("Dropout", 0.5, inputs=[f(2, 4)], eval_=True)
layer("Dropout2D", 0.5, inputs=[f(2, 3, 4, 4)], eval_=True)
layer("Dropout3D", 0.5, inputs=[f(2, 3, 2, 2, 2)], eval_=True)
layer("AlphaDropout", 0.5, inputs=[f(2, 4)], eval_=True)
layer("Embedding", 6, 4, inputs=[i(2, 3, hi=6)], padding_idx=2)
layer("Upsample", inputs=[f(1, 2, 3, 4)], scale_factor=2, mode="bilinear",
      tol=1e-4)
layer("UpsamplingNearest2D", inputs=[f(1, 2, 3, 4)], size=[5, 7])
layer("UpsamplingBilinear2D", inputs=[f(1, 2, 3, 4)], scale_factor=2,
      tol=1e-4)
layer("Pad1D", [1, 2], inputs=[f(1, 2, 4)], mode="reflect")
layer("Pad2D", [1, 2, 0, 1], inputs=[f(1, 2, 3, 4)], value=1.5)
layer("Pad3D", [1, 0, 1, 0, 0, 1], inputs=[f(1, 1, 2, 3, 3)],
      mode="replicate")
layer("ZeroPad2D", [1, 1, 2, 0], inputs=[f(1, 2, 3, 3)])
layer("Bilinear", 3, 4, 5, inputs=[f(2, 3), f(2, 4)], tol=1e-4)
layer("CosineSimilarity", inputs=[f(3, 4), f(3, 4)])
layer("PairwiseDistance", inputs=[f(3, 4), f(3, 4)])
layer("Unfold", 2, inputs=[f(1, 2, 4, 4)])
layer("Fold", [4, 4], 2, inputs=[f(1, 8, 9)])
layer("PixelShuffle", 2, inputs=[f(1, 8, 2, 2)])
layer("PixelUnshuffle", 2, inputs=[f(1, 2, 4, 4)])
layer("ChannelShuffle", 2, inputs=[f(1, 4, 2, 2)])
layer("MaxOut", 2, inputs=[n(2, 4, 3)])
# activation
for _a in ["ReLU", "ReLU6", "LeakyReLU", "ELU", "SELU", "CELU", "GELU",
           "Silu", "Swish", "Mish", "Hardswish", "Hardsigmoid", "Hardtanh",
           "Hardshrink", "Softshrink", "Tanhshrink", "Softplus", "Softsign",
           "Sigmoid", "LogSigmoid", "Tanh", "Softmax", "LogSoftmax", "GLU",
           "ThresholdedReLU"]:
    layer(_a, inputs=[n(3, 4, scale=2.0)])
layer("PReLU", 3, inputs=[n(2, 3, 4)])
layer("Maxout", 2, inputs=[n(2, 4, 3)])
layer("RReLU", inputs=[n(3, 4)], eval_=True)
layer("Softmax2D", inputs=[n(2, 3, 2, 2)])
COMMON = list(L)
L.clear()

# norm
for _b in ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "SyncBatchNorm"]:
    layer(_b, 3, inputs=[n(4, 3, 2, 2)], tol=1e-4)
    layer(_b, 3, inputs=[n(4, 3, 2, 2)], eval_=True, tol=1e-4, tag="eval")
layer("BatchNorm3D", 2, inputs=[n(2, 2, 2, 2, 2)], tol=1e-4)
layer("LayerNorm", [3, 4], inputs=[n(2, 3, 4)], tol=1e-4)
layer("RMSNorm", 8, inputs=[n(2, 3, 8)], tol=1e-4)
layer("GroupNorm", 2, 4, inputs=[n(2, 4, 3, 3)], tol=1e-4)
for _k, _s in [("InstanceNorm1D", (2, 3, 5)), ("InstanceNorm2D", (2, 3, 2, 2)),
               ("InstanceNorm3D", (2, 3, 2, 2, 2))]:
    layer(_k, 3, inputs=[n(*_s)], tol=1e-4)
layer("LocalResponseNorm", 3, inputs=[n(2, 5, 2, 2)], tol=1e-4)
layer("SpectralNorm", [3, 4], inputs=[n(3, 4)], tol=1e-4)
# loss
layer("CrossEntropyLoss", inputs=[n(6, 5), i(6, hi=5)], tol=1e-4)
layer("CrossEntropyLoss", inputs=[n(6, 5), probs(6, 5)], tol=1e-4,
      tag="soft", soft_label=True, label_smoothing=0.1)
layer("MSELoss", inputs=[n(3, 4), n(3, 4)], tol=1e-4)
layer("L1Loss", inputs=[n(3, 4), n(3, 4)], tol=1e-4)
layer("NLLLoss", inputs=[n(6, 5), i(6, hi=5)], tol=1e-4)
layer("BCELoss", inputs=[f(3, 4), f(3, 4)], tol=1e-4)
layer("BCEWithLogitsLoss", inputs=[n(3, 4), f(3, 4)], tol=1e-4)
layer("SmoothL1Loss", inputs=[n(3, 4), n(3, 4)], tol=1e-4)
layer("KLDivLoss", inputs=[n(3, 4), f(3, 4)], tol=1e-4)
layer("MarginRankingLoss", inputs=[n(5), n(5), f(5)], tol=1e-4)
layer("CTCLoss", inputs=[n(5, 2, 4), lambda r: np.array([[1, 2], [3, 3]]),
                         lambda r: np.array([5, 4]),
                         lambda r: np.array([2, 2])], tol=1e-4)
layer("HingeEmbeddingLoss", inputs=[n(3, 4), lambda r: np.where(
    r.uniform(size=(3, 4)) < 0.5, 1.0, -1.0).astype(np.float32)], tol=1e-4)
layer("CosineEmbeddingLoss", inputs=[n(4, 3), n(4, 3), lambda r: np.array(
    [1, -1, 1, -1], np.float32)], tol=1e-4)
layer("TripletMarginLoss", inputs=[n(4, 3), n(4, 3), n(4, 3)], tol=1e-4)
layer("SoftMarginLoss", inputs=[n(3, 4), lambda r: np.where(
    r.uniform(size=(3, 4)) < 0.5, 1.0, -1.0).astype(np.float32)], tol=1e-4)
layer("MultiLabelSoftMarginLoss", inputs=[n(3, 4), f(3, 4)], tol=1e-4)
layer("PoissonNLLLoss", inputs=[n(3, 4), f(3, 4)], tol=1e-4)
layer("RNNTLoss", inputs=[n(2, 3, 3, 4), lambda r: np.array([[1, 2], [3, 1]]),
                          lambda r: np.array([3, 2]),
                          lambda r: np.array([2, 1])], tol=1e-4)
layer("HSigmoidLoss", 3, 5, inputs=[n(4, 3), lambda r: np.array(
    [0, 4, 2, 3])], tol=1e-4)
layer("MultiMarginLoss", inputs=[n(4, 5), lambda r: np.array([0, 4, 2, 3])],
      tol=1e-4)
layer("TripletMarginWithDistanceLoss", inputs=[n(4, 3), n(4, 3), n(4, 3)],
      tol=1e-4)

NORM_LOSS = list(L)

LAYER_NAMES = sorted({p.values[0] for p in COMMON + NORM_LOSS})


def _build(paddle, cls, args, kwargs, eval_):
    paddle.seed(3)
    lay = getattr(paddle.nn, cls)(*args, **kwargs)
    if eval_:
        lay.eval()
    return lay


def _run(paddle, lay, arrays):
    xs = [paddle.to_tensor(a, stop_gradient=a.dtype.kind != "f")
          for a in arrays]
    out = lay(*xs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    wrng = np.random.default_rng(5)
    loss = None
    for o in outs:
        w = wrng.uniform(0.5, 1.5, o.shape).astype(np.float32)
        term = paddle.sum(o * paddle.to_tensor(w))
        loss = term if loss is None else loss + term
    loss.backward()
    grads = [x.grad.numpy() if x.grad is not None else np.zeros(x.shape)
             for x in xs if not x.stop_gradient]
    pgrads = [(k, v.grad.numpy() if v.grad is not None else None)
              for k, v in lay.state_dict().items() if not v.stop_gradient]
    return [o.numpy() for o in outs], grads, pgrads


def check_layer(cls, args, kwargs, inputs, eval_, tol):
    rng = np.random.default_rng(11)
    arrays = [np.asarray(m(rng)) for m in inputs]
    jl = _build(jpaddle, cls, args, kwargs, eval_)
    tl = _build(tpaddle, cls, args, kwargs, eval_)
    assert list(tl.state_dict()) == list(jl.state_dict())
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    jout, jg, jpg = _run(jpaddle, jl, arrays)
    tout, tg, tpg = _run(tpaddle, tl, arrays)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                                   atol=tol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert [k for k, _ in tpg] == [k for k, _ in jpg]
    for (k, a), (_, b) in zip(tpg, jpg):
        if b is None:
            assert a is None or not np.any(a), k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    # the state the forward updates (batch norm's running statistics,
    # spectral norm's u / v) follows the same update
    for k, v in jl.state_dict().items():
        np.testing.assert_allclose(tl.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)



# conv and pooling (tests/test_torch_vision.py)
L.clear()
_T = dict(tol=1e-4)
layer("Conv1D", 3, 4, 3, inputs=[n(2, 3, 8)], padding=1, **_T)
layer("Conv2D", 3, 4, 3, inputs=[n(2, 3, 6, 6)], stride=2, padding=1, **_T)
layer("Conv2D", 4, 6, 3, inputs=[n(2, 4, 6, 6)], tag="groups-nobias",
      groups=2, dilation=2, padding="SAME", bias_attr=False, **_T)
layer("Conv3D", 2, 3, 2, inputs=[n(1, 2, 4, 4, 4)], **_T)
layer("Conv1DTranspose", 3, 2, 3, inputs=[n(2, 3, 5)], stride=2, **_T)
layer("Conv2DTranspose", 3, 2, 3, inputs=[n(2, 3, 4, 4)], stride=2,
      padding=1, output_padding=1, **_T)
layer("Conv3DTranspose", 2, 2, 2, inputs=[n(1, 2, 3, 3, 3)], **_T)
layer("MaxPool1D", 2, inputs=[n(2, 3, 8)], **_T)
layer("MaxPool2D", 3, 2, 1, inputs=[n(2, 3, 7, 7)], ceil_mode=True, **_T)
layer("MaxPool3D", 2, inputs=[n(1, 2, 4, 4, 4)], **_T)
layer("AvgPool1D", 3, 2, 1, inputs=[n(2, 3, 7)], **_T)
layer("AvgPool2D", 3, 2, 1, inputs=[n(2, 3, 7, 6)], ceil_mode=True,
      exclusive=False, **_T)
layer("AvgPool3D", 2, inputs=[n(1, 2, 4, 4, 4)], **_T)
layer("AdaptiveAvgPool1D", 3, inputs=[n(2, 3, 8)], **_T)
layer("AdaptiveAvgPool2D", (1, 1), inputs=[n(2, 3, 5, 5)], **_T)
layer("AdaptiveAvgPool3D", 2, inputs=[n(1, 2, 4, 4, 4)], **_T)
layer("AdaptiveMaxPool1D", 3, inputs=[n(2, 3, 7)], **_T)
layer("AdaptiveMaxPool2D", 2, inputs=[n(2, 3, 5, 5)], **_T)
layer("AdaptiveMaxPool3D", 2, inputs=[n(1, 2, 4, 4, 4)], **_T)
for _nd, _lead, _outs in [(1, (2, 3), (4,)), (2, (2, 3), (3, 2)),
                          (3, (1, 2), (2, 2, 2))]:
    layer(f"MaxUnPool{_nd}D", 2,
          inputs=[n(*(_lead + _outs)), unpool_idx(_lead, _outs, 2)], **_T)

VISION = list(L)
VISION_NAMES = sorted({p.values[0] for p in VISION})


# RNN and transformer layers (tests/test_torch_rnn_transformer.py): the
# ones whose outputs are a flat tuple; LSTM's nested states, the caches
# and the wrappers over given cells are checked in that file
L.clear()
_T = dict(tol=1e-4)
layer("SimpleRNNCell", 4, 4, inputs=[n(2, 4), n(2, 4)], **_T)
layer("SimpleRNNCell", 4, 4, inputs=[n(2, 4), n(2, 4)], tag="relu",
      activation="relu", **_T)
layer("GRUCell", 4, 4, inputs=[n(2, 4), n(2, 4)], **_T)
layer("GRUCell", 4, 4, inputs=[n(2, 4)], tag="nostate-nobias",
      bias_ih_attr=False, bias_hh_attr=False, **_T)
for _d, _tm, _shape in (("forward", False, (2, 3, 4)),
                        ("backward", True, (3, 2, 4)),
                        ("bidirect", False, (2, 3, 4))):
    for _cls in ("SimpleRNN", "GRU"):
        layer(_cls, 4, 4, inputs=[n(*_shape)], tag=f"{_d}-tm{int(_tm)}",
              num_layers=2, direction=_d, time_major=_tm, **_T)
layer("GRU", 4, 4, inputs=[n(2, 3, 4), n(2, 2, 4)], tag="init-states",
      num_layers=2, **_T)
layer("MultiHeadAttention", 8, 2, inputs=[n(2, 4, 8), n(2, 5, 8),
                                          n(2, 5, 8), n(4, 5)], **_T)
layer("MultiHeadAttention", 8, 2, inputs=[n(2, 4, 8)], tag="kdim-vdim",
      kdim=8, vdim=8, **_T)
layer("TransformerEncoderLayer", 8, 2, 16, inputs=[n(2, 5, 8)],
      dropout=0.0, **_T)
layer("TransformerEncoderLayer", 8, 2, 16, inputs=[n(2, 5, 8), n(5, 5)],
      tag="pre-norm-gelu", dropout=0.0, activation="gelu",
      normalize_before=True, **_T)
layer("TransformerDecoderLayer", 8, 2, 16, inputs=[n(2, 4, 8), n(2, 5, 8)],
      dropout=0.0, **_T)
layer("TransformerDecoderLayer", 8, 2, 16,
      inputs=[n(2, 4, 8), n(2, 5, 8), n(4, 4), n(4, 5)], tag="pre-norm",
      dropout=0.0, normalize_before=True, **_T)
layer("Transformer", 8, 2, 2, 2, 16, inputs=[n(2, 5, 8), n(2, 4, 8)],
      dropout=0.0, **_T)
layer("Transformer", 8, 2, 1, 2, 16, inputs=[n(2, 5, 8), n(2, 4, 8)],
      tag="pre-norm-eval", normalize_before=True, eval_=True, **_T)

SEQ = list(L)


# layers whose outputs nest or that take built sublayers: both packages
# built the same way, run by ``call(P, layer, inputs)``
def _flat(out):
    if out is None:
        return []
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def pair_run(build, arrays, call, seed=3):
    """Build in both packages, carry the JAX weights across, run ``call``
    on the same inputs and return (outputs, input grads, param grads)
    of each, the weighted sum of every output back-propagated."""
    res = []
    jl = None
    for P in (jpaddle, tpaddle):
        P.seed(seed)
        lay = build(P)
        if jl is None:
            jl = lay
        else:
            assert list(lay.state_dict()) == list(jl.state_dict())
            lay.set_state_dict({k: v.numpy()
                                for k, v in jl.state_dict().items()})
        xs = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f")
              for a in arrays]
        outs = _flat(call(P, lay, xs))
        wrng = np.random.default_rng(5)
        loss = None
        for o in outs:
            w = wrng.uniform(0.5, 1.5, o.shape).astype(np.float32)
            term = P.sum(o * P.to_tensor(w))
            loss = term if loss is None else loss + term
        loss.backward()
        res.append(([o.numpy() for o in outs],
                    [x.grad.numpy() if x.grad is not None else None
                     for x in xs if not x.stop_gradient],
                    {k: (v.grad.numpy() if v.grad is not None else None)
                     for k, v in lay.state_dict().items()}))
    return res


def compare_runs(res, tol=1e-4):
    """``pair_run``'s two results: outputs, input and parameter
    gradients within ``tol`` (f32)."""
    (jo, jg, jp), (to, tg, tp) = res
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol,
                                   atol=tol)
    for a, b in zip(tg, jg):
        if b is None:
            assert a is None or not np.any(a)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    assert list(tp) == list(jp)
    for k in jp:
        if jp[k] is None:
            assert tp[k] is None or not np.any(tp[k]), k
        else:
            np.testing.assert_allclose(tp[k], jp[k], err_msg=k, rtol=tol,
                                       atol=tol)
