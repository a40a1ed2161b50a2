"""The sharded train step against the reference's unsharded step (cases
and tolerances: `tests/_torch_sharded_cases.py`): mistral on a (2, 2, 2)
world of threaded CPU ranks with a mask whose token counts differ by
rank, and phi3 on (data 1, model 8), where four ranks share one KV
head's columns."""
import pytest

from _torch_sharded_cases import check_matches_reference


@pytest.mark.parametrize("case", ["mistral_masked_2x2x2", "phi3_1x8"])
def test_sharded_step_matches_single_device(case):
    check_matches_reference(case)
