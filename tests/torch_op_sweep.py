"""The op sweep shared by ``tests/test_torch_ops_{0..8}.py``: the
cases of ``paddle_tpu_torch.testing.op_cases`` run through the JAX
package's ``OP_LIBRARY`` (its own eager ops on the CPU) and the port's,
the port on the CPU place.  Split nine ways so that no xdist worker
holds the whole sweep (the JAX side takes ~2.5 min on the CPU)."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.ops.registry import OP_LIBRARY as JOPS
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.ops.registry import OP_LIBRARY as TOPS
from paddle_tpu_torch.testing import op_cases

PARTS = 9


def cases(part):
    return op_cases.PARITY[part::PARTS]


def laws(part):
    return op_cases.LAWS[part::PARTS]


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


def check_parity(c):
    """The port's outputs and gradients against the JAX package's, at
    the case's tolerance (f32 1e-5, reductions / linalg / grads 1e-4,
    bf16 2e-2)."""
    want = op_cases.run(c, jpaddle, JOPS)
    got = op_cases.run(c, tpaddle, TOPS)
    op_cases.compare(c, got, want)


def check_law(law):
    """The law and reproducibility checks, on the port and (so the
    checks themselves are held to a second implementation) on JAX."""
    law.check(tpaddle)
    law.check(jpaddle)


def ids(items):
    return [c.id for c in items]


__all__ = ["cases", "laws", "check_parity", "check_law", "ids", "on_cpu",
           "np", "JOPS", "TOPS", "op_cases"]
