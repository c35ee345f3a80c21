"""PTQ -> int8 artifact -> serve: the quantized-deployment workflow on
the port (the port of ``examples/quantize_serve.py``).

Reference analog: the static post-training-quantization demo flow
(QuantizationTransformPass calibrate -> QuantizationFreezePass ->
C++ predictor).  Here: observe -> calibrate -> convert(to_int8=True) ->
jit.save -> inference.Predictor; the same artifact also serves from
pure C through the C ABI (see paddle_tpu_torch/examples/serve_capi.c).

Run: python -m paddle_tpu_torch.examples.quantize_serve  (on the card;
pass ``--device cpu`` for the CPU)
"""
import argparse
import os
import shutil
import tempfile

import numpy as np


def main(device=None, verbose=True):
    """The workflow on ``device`` (the card unless it names another);
    returns the layers frozen to int8, the eager and the served relative
    errors against float32 and the payload's size against float32's."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.quantization import (KLObserver, PTQ, QuantConfig,
                                               AbsmaxObserver, QuanterFactory,
                                               QuantizedLinear)

    dev = resolve_device(device)
    paddle.set_device("cpu" if dev.type == "cpu" else f"gpu:{dev.index}")
    paddle.seed(0)
    net = nn.Sequential(nn.Linear(64, 128), nn.ReLU(),
                        nn.Linear(128, 32), nn.ReLU(),
                        nn.Linear(32, 10))
    net.eval()
    rng = np.random.default_rng(0)
    calib = rng.standard_normal((8, 32, 64)).astype(np.float32)
    x_eval = rng.standard_normal((16, 64)).astype(np.float32)
    ref = net(paddle.to_tensor(x_eval)).numpy()

    # 1. observe: KL entropy calibration for activations (robust to
    # outliers), absmax for weights
    cfg = QuantConfig(activation=QuanterFactory(KLObserver),
                      weight=QuanterFactory(AbsmaxObserver))
    ptq = PTQ(cfg)
    observed = ptq.quantize(net)
    for batch in calib:
        observed(paddle.to_tensor(batch))

    # 2. freeze to int8 compute
    q = ptq.convert(observed, to_int8=True)
    q.eval()
    n_int8 = sum(isinstance(s, QuantizedLinear) for s in q.sublayers())
    out = q(paddle.to_tensor(x_eval)).numpy()
    rel = float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-9))
    if verbose:
        print(f"{n_int8} layers frozen to int8 compute; "
              f"eager rel err vs fp32: {rel:.4f}")

    # 3. export + serve
    d = tempfile.mkdtemp(prefix="quantize_serve_")
    try:
        prefix = os.path.join(d, "mlp_int8")
        paddle.jit.save(q, prefix,
                        input_spec=[InputSpec([16, 64], "float32")])
        fp32_prefix = os.path.join(d, "mlp_fp32")
        paddle.jit.save(net, fp32_prefix,
                        input_spec=[InputSpec([16, 64], "float32")])
        shrink = (os.path.getsize(prefix + ".pdiparams")
                  / os.path.getsize(fp32_prefix + ".pdiparams"))
        config = inference.Config(prefix + ".pdmodel")
        if dev.type == "cpu":
            config.disable_gpu()
        else:
            config.enable_use_gpu(100, dev.index or 0)
        pred = inference.create_predictor(config)
        got = pred.run([x_eval])[0]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rel_served = float(np.abs(got - ref).max()
                       / (np.abs(ref).max() + 1e-9))
    if verbose:
        print(f"served rel err: {rel_served:.4f}; "
              f"weights payload: {shrink:.2f}x of fp32")
    return dict(int8_layers=n_int8, rel_eager=rel, rel_served=rel_served,
                shrink=shrink, served_equals_eager=bool(
                    np.array_equal(got, out)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    res = main(device=ap.parse_args().device)
    assert res["rel_served"] < 0.1 and res["shrink"] < 0.5, res
    print("int8 serving flow OK")
