"""Sharded prefill and decode of rwkv6_1_6b on a threaded (data 2, model 2)
world against the reference's single-device results
(`tests/_torch_serve_cases.py`)."""
from _torch_serve_cases import check


def test_sharded_serving_equals_reference():
    check("rwkv6_1_6b")
