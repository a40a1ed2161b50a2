"""whisper_large_v3's gradients and train steps against the reference's, on the
CPU (cases and tolerances: `tests/_torch_train_cases.py`)."""
import pytest

from _torch_train_cases import (check_loss_and_grads, check_sharded_steps,
                                check_three_steps)


@pytest.mark.parametrize("name", ["whisper_large_v3"])
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", ["whisper_large_v3"])
def test_three_steps_match_reference(name):
    check_three_steps(name)


@pytest.mark.parametrize("dims", [(1, 8)], ids=["1x8"])
def test_sharded_steps_match_reference(dims):
    """A rank's query columns hold half a head: it takes its share of the
    (row, head) pairs; cross-attention; the encoder."""
    check_sharded_steps("whisper_large_v3", dims)
