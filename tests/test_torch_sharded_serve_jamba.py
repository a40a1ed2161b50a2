"""Sharded prefill and decode of jamba_v0_1_52b on a threaded (data 2, model 2)
world against the reference's single-device results
(`tests/_torch_serve_cases.py`)."""
from _torch_serve_cases import check


def test_sharded_serving_equals_reference():
    check("jamba_v0_1_52b")
