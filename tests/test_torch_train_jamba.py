"""jamba_v0_1_52b's gradients and train steps against the reference's, on the
CPU (cases and tolerances: `tests/_torch_train_cases.py`)."""
import pytest

from _torch_train_cases import check_loss_and_grads, check_three_steps


@pytest.mark.parametrize("name", ["jamba_v0_1_52b"])
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", ["jamba_v0_1_52b"])
def test_three_steps_match_reference(name):
    check_three_steps(name)
