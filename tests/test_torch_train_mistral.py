"""mistral_nemo_12b's gradients and train steps against the reference's, on the
CPU (cases and tolerances: `tests/_torch_train_cases.py`)."""
import pytest

from _torch_train_cases import (check_bf16_grads, check_compress_pod_grads,
                                check_loss_and_grads, check_sharded_compress_pod_grads,
                                check_sharded_steps, check_three_steps)


@pytest.mark.parametrize("name", ["mistral_nemo_12b"])
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", ["mistral_nemo_12b"])
def test_three_steps_match_reference(name):
    check_three_steps(name)


def test_bf16_grads_match_reference():
    check_bf16_grads()


def test_compress_pod_grads_matches_reference():
    check_compress_pod_grads()


@pytest.mark.parametrize("dims", [(1, 4)], ids=["1x4"])
def test_sharded_steps_match_reference(dims):
    """One query head a rank, two ranks to a KV head: each gathers the KV
    head's columns it shares and slices them."""
    check_sharded_steps("mistral_nemo_12b", dims)


def test_sharded_step_compresses_the_whole_gradient():
    check_sharded_compress_pod_grads()
