"""The port's norm and loss layers against the JAX package's (the cases
and the comparison: ``tests/torch_nn_cases.py``)."""
import pytest

import paddle_tpu_torch as tpaddle
from torch_nn_cases import NORM_LOSS, check_layer


@pytest.fixture(autouse=True)
def on_cpu():
    tpaddle.set_device("cpu")
    yield


@pytest.mark.parametrize("cls,args,kwargs,inputs,eval_,tol", NORM_LOSS)
def test_layer_matches_the_reference(cls, args, kwargs, inputs, eval_, tol):
    check_layer(cls, args, kwargs, inputs, eval_, tol)
