"""rwkv6_1_6b's gradients and train steps against the reference's, on the
CPU (cases and tolerances: `tests/_torch_train_cases.py`)."""
import pytest

from _torch_train_cases import (check_loss_and_grads, check_sharded_steps,
                                check_three_steps)


@pytest.mark.parametrize("name", ["rwkv6_1_6b"])
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", ["rwkv6_1_6b"])
def test_three_steps_match_reference(name):
    check_three_steps(name)


@pytest.mark.parametrize("dims", [(2, 2)], ids=["2x2"])
def test_sharded_steps_match_reference(dims):
    """RWKV-6's heads split over the model ranks; the channel mix, whose
    weights the rules leave whole, on each rank's own positions."""
    check_sharded_steps("rwkv6_1_6b", dims)
