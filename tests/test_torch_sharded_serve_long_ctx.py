"""The long-context layout (B = 1: the caches' S over data + model, the
tokens replicated) of gemma3 on a threaded (data 2, model 2) world against
the reference's single-device results (`tests/_torch_serve_cases.py`)."""
from _torch_serve_cases import check


def test_long_context_layout_equals_reference():
    check("gemma3_27b", B=1)
