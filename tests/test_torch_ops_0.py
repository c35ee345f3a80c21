"""Op sweep, part 0 of 9 (see ``tests/torch_op_sweep.py``): the port's
ops against the JAX package's on the same seeded inputs, forward and
gradients; the random ops held to their laws."""
import pytest

from torch_op_sweep import cases, check_law, check_parity, ids, laws, \
    on_cpu  # noqa: F401 - the autouse fixture

CASES = cases(0)
LAWS = laws(0)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_matches_the_reference(case):
    check_parity(case)


@pytest.mark.parametrize("law", LAWS, ids=ids(LAWS))
def test_random_op_law(law):
    check_law(law)


# reference ops the port does not have yet: none (the vision stack
# brought conv 6, pooling 17, functional/vision 3, functional/extended
# 5, geometric 4 and vision.ops 3)
NOT_YET = set()
PORTED_MODULES = {
    "ops.registry", "tensor.creation", "tensor.math", "tensor.logic",
    "tensor.manipulation", "tensor.linalg", "tensor.search",
    "tensor.random", "tensor.attribute", "tensor.einsum",
    "nn.functional.activation", "nn.functional.common",
    "nn.functional.norm", "nn.functional.loss",
    "nn.functional.conv", "nn.functional.pooling",
    "nn.functional.vision", "nn.functional.extended", "geometric",
    "vision.ops",
    # modules with no registry op, listed as ported
    "jit.api", "jit.dy2static", "static.program", "static.control_flow",
    "static.nn", "static.sequence", "static.compat", "ops.codegen",
    "_C_ops", "incubate.asp.utils", "incubate.asp.asp",
    "incubate.distributed.models.moe.gate",
    "incubate.distributed.models.moe.moe_layer",
}


def test_registry_covers_the_reference_ops_of_ported_modules():
    from torch_op_sweep import JOPS, TOPS, op_cases
    mod = {k: v.fn.__module__.split(".", 1)[1] for k, v in JOPS.items()}
    ported = {k for k, m in mod.items() if m in PORTED_MODULES}
    assert len(ported) == 385 and len(JOPS) == 385
    assert set(JOPS) - ported == NOT_YET
    assert set(TOPS) == ported
    # each op lives in the port's module of the same name
    for k in ported:
        assert TOPS[k].fn.__module__ == "paddle_tpu_torch." + mod[k], k
    # and each has a parity case or, if random, a law case
    assert op_cases.covered_ops() == ported
