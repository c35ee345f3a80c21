"""Op sweep, part 5 of 9 (see ``tests/torch_op_sweep.py``): the port's
ops against the JAX package's on the same seeded inputs, forward and
gradients; the random ops held to their laws."""
import pytest

from torch_op_sweep import cases, check_law, check_parity, ids, laws, \
    on_cpu  # noqa: F401 - the autouse fixture

CASES = cases(5)
LAWS = laws(5)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op_matches_the_reference(case):
    check_parity(case)


@pytest.mark.parametrize("law", LAWS, ids=ids(LAWS))
def test_random_op_law(law):
    check_law(law)
