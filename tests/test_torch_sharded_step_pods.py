"""The sharded train step on a (2, 2, 2) world of threaded CPU ranks for
the hash router's key planes, against the reference's unsharded step
(cases and tolerances: `tests/_torch_sharded_cases.py`)."""
import pytest

from _torch_sharded_cases import check_matches_reference


@pytest.mark.parametrize("case", ["granite_hash_2x2x2"])
def test_sharded_step_matches_single_device(case):
    check_matches_reference(case)
