"""cfr_bench/spans.kernel_ms: the trace's kernels attributed to the
calls of a span by the calls' device intervals, across the trace's base."""

import pytest

from cfr_bench import spans

STEP = spans.TRACE_BASE_S * 10 ** 9


def _case(base_k: int):
    """A span of two calls on the snapshot's clock and six kernels on the
    trace's (us from a base of base_k steps): the first call holds 1 + 2
    ms, the second 4 ms, and the rest fall between or after."""
    t = base_k * STEP + 1_234_567_890_123
    s = {"frm": {"calls": 2, "device_ns": [(t, t + 5_000_000),
                                           (t + 8_000_000, t + 13_000_000)]},
         "certify.batch": {"calls": 1,
                           "device_ns": [(t - 1_000, t + 20_000_000)]}}
    us = (t - base_k * STEP) / 1e3
    kernels = [("a", us + 500, 1000), ("b", us + 2000, 2000),
               ("gap", us + 6000, 1500), ("c", us + 8500, 4000),
               ("late", us + 15000, 100), ("later", us + 18000, 900)]
    return kernels, s


@pytest.mark.parametrize("base_k", [0, 1, 228])
def test_kernel_ms_attributes_kernels_to_calls(base_k):
    kernels, s = _case(base_k)
    assert spans.kernel_ms(kernels, s, "frm") == pytest.approx([3.0, 4.0])
    assert spans.kernel_ms(kernels, s, "certify.batch") == pytest.approx(
        [9.5])


def test_kernel_ms_without_kernels_or_intervals_is_none():
    kernels, s = _case(1)
    assert spans.kernel_ms([], s, "frm") is None
    assert spans.kernel_ms(kernels, s, "gallery_head") is None
    s["frm"]["device_ns"] = []
    assert spans.kernel_ms(kernels, s, "frm") is None
    assert spans.kernel_ms(kernels, None, "frm") is None
