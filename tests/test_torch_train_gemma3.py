"""gemma3_27b_hashed's gradients and train steps against the reference's, on the
CPU (cases and tolerances: `tests/_torch_train_cases.py`)."""
import pytest

from _torch_train_cases import (check_loss_and_grads, check_sharded_steps,
                                check_three_steps)


@pytest.mark.parametrize("name", ["gemma3_27b_hashed"])
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", ["gemma3_27b_hashed"])
def test_three_steps_match_reference(name):
    check_three_steps(name)


@pytest.mark.parametrize("dims", [(2, 2)], ids=["2x2"])
def test_sharded_steps_match_reference(dims):
    """The hashed embedding, the tail, sliding windows on the split heads."""
    check_sharded_steps("gemma3_27b_hashed", dims)
