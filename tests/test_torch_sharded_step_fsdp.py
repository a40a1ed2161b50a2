"""The sharded train step on a (2, 2, 2) world of threaded CPU ranks for
llama4 under adafactor with `fsdp_pods` (a dimension split data-major
over ("data", "pod")), against the reference's unsharded step (cases and
tolerances: `tests/_torch_sharded_cases.py`)."""
import pytest

from _torch_sharded_cases import check_matches_reference


@pytest.mark.parametrize("case", ["llama4_adafactor_fsdp_pods_2x2x2"])
def test_sharded_step_matches_single_device(case):
    check_matches_reference(case)
