"""The byte count, the roofline share and the trace's arithmetic on
hand-worked cases."""
import numpy as np
import pytest

from hashbench import devtrace, roofline
from hashbench.harness import Context
from hashbench.metrics import _roofline

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("lengths,N,want", [
    ([3, 0, 5, 10], 8, 3 + 0 + 5 + 8),  # a row past N loads N
    ([], 8, 0),
])
def test_live_tokens(lengths, N, want):
    assert roofline.live_tokens(lengths, N) == want


@pytest.mark.parametrize("key_bytes,want", [
    # tokens 4 x 8, keys K x (longest 5 + sentinel + m1) x key_bytes,
    # lengths 4 x 2, residues 4 x 2 x 2
    (8, 32 + 2 * 7 * 8 + 8 + 16),
    (4, 32 + 2 * 7 * 4 + 8 + 16),
])
def test_probe_call_bytes(key_bytes, want):
    assert roofline.probe_call_bytes([3, 5], 8, 2, key_bytes) == want


def test_least_seconds():
    assert roofline.least_seconds(3.35e12, H100) == 1.0
    assert roofline.least_seconds(1, "cpu") is None


def _trace(ops, batches=(0,), kind=H100, host=()):
    return devtrace.Trace(list(batches), list(ops), 1.0, kind, sorted(host))


def test_roofline_share():
    ctx = Context(np.array([[3, 5]]), 8, 2)
    nbytes = roofline.probe_call_bytes([3, 5], 8, 2, 8)
    ops = [("void engine_tile_kernel<IntEngine, 9, false, true>(x)", 0.0, 1e-9),
           ("void engine_finish<IntEngine>(y)", 2e-9, 3e-9),
           ("void engine_tile_kernel<GfEngine, 9, false, false>(z)", 5.0, 6.0)]
    share = _roofline.share(_trace(ops), ctx, "IntEngine", 8)
    assert share == pytest.approx(100 * nbytes / 3.35e12 / 2e-9)
    # no kernel of the tag, or a card the table lacks: nothing to read
    assert _roofline.share(_trace(ops[:2]), ctx, "GfEngine", 4) is None
    assert _roofline.share(_trace(ops, kind="cpu"), ctx, "IntEngine", 8) is None


def test_busy_and_breakdown():
    ops = [("a(1)", 0.0, 1.0), ("b", 0.5, 2.0), ("a(2)", 3.0, 4.0), ("a", 6.0, 7.0)]
    host = [(2.1, 2.9, "cudaLaunchKernel"), (4.0, 5.0, "cudaEventSynchronize"),
            (6.1, 6.5, "cudaLaunchKernel")]
    t = _trace(ops, host=host)
    assert devtrace.merged(ops) == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert t.busy_s() == 4.0
    bd = t.breakdown()
    assert bd["device_ops"] == [["a", 3.0], ["b", 1.5]]
    # the gap 2-3 lies under a launch; 4-6's middle (5.0) is the wait's
    # end, so it counts as the wait
    assert bd["idle_gaps"] == [["cudaEventSynchronize", 2.0], ["cudaLaunchKernel", 1.0]]
    # a gap under no runtime call is the host's outside it
    t = _trace(ops[:3], host=host[2:])
    assert t.breakdown()["idle_gaps"] == [[devtrace.BETWEEN, 1.0]]
