"""``mapping_steps`` of the port vs the JAX reference on the dense oracle
renderer: the problem, the checks and their tolerances of
tests/test_torch_mapping_steps.py, in a file of its own so that each
file's JAX compiles stay short."""

import pytest

from test_torch_mapping_steps import check_parameters, check_state


@pytest.mark.parametrize("variant", ["oracle"])
def test_mapping_steps_parameters_match(variant):
    check_parameters(variant)


@pytest.mark.parametrize("variant", ["oracle"])
def test_mapping_steps_state_match(variant):
    check_state(variant)
