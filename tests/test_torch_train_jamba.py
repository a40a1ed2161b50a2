"""jamba_v0_1_52b's gradients and train steps against the reference's, on the
CPU (cases and tolerances: `tests/_torch_train_cases.py`)."""
import pytest

from _torch_train_cases import (check_loss_and_grads, check_sharded_steps,
                                check_three_steps)


@pytest.mark.parametrize("name", ["jamba_v0_1_52b"])
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", ["jamba_v0_1_52b"])
def test_three_steps_match_reference(name):
    check_three_steps(name)


@pytest.mark.parametrize("dims", [(1, 4)], ids=["1x4"])
def test_sharded_steps_match_reference(dims):
    """Mamba's channels split over the model ranks (in_proj regathered into
    each rank's columns of x and z), one expert a rank, the hybrid block."""
    check_sharded_steps("jamba_v0_1_52b", dims)
