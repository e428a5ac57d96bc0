"""The copied FLOP and roofline arithmetic against counts by hand."""

import pytest

from benchmark.arith.flops import core_tokens, denoiser_forward_flops, mmdit_forward_flops
from benchmark.arith.roofline import attention_fwd_bound_s
from benchmark.tests.tiny import frozen


def test_core_tokens():
    assert core_tokens(frozen("spec8")) == {"video": 96, "audio": 37, "mouth": 288,
                                            "total": 421}
    assert core_tokens(frozen("mvp-v2a"))["total"] == 133


def test_forward_flops_by_hand():
    # spec8: 16 x (2*421*1024*3072 + 4*421^2*1024 + 2*421*1024^2 + 4*421*1024*4096)
    per_layer = 2648702976 + 725979136 + 882900992 + 7063207936
    assert mmdit_forward_flops(421, 1024, 16) == 16 * per_layer
    assert denoiser_forward_flops(frozen("spec8")) == pytest.approx(181.1e9, rel=1e-3)
    assert denoiser_forward_flops(frozen("mvp-v2a")) == pytest.approx(6.98e9, rel=1e-3)
    # a spec8 batch: 25 steps x 2B = 16 forwards
    assert 25 * 16 * denoiser_forward_flops(frozen("spec8")) == pytest.approx(72.4e12, rel=2e-3)


def test_attention_bounds_of_the_kernel_table():
    # the kernel table's bounds: 16.5 us at [16, 8, 421, 128], 2.6 at [16, 8, 133, 64]
    assert attention_fwd_bound_s((16, 8, 421, 128), "bfloat16", [421] * 16, False) \
        == pytest.approx(16.5e-6, rel=5e-3)
    assert attention_fwd_bound_s((16, 8, 133, 64), "bfloat16", [133] * 16, False) \
        == pytest.approx(2.6e-6, rel=2e-2)
    # bytes bind at these sizes; operations at a long sequence
    b = attention_fwd_bound_s((16, 4, 1152, 128), "bfloat16", [1101] * 16, True)
    assert b == pytest.approx(4 * 4 * 1152 * 128 * 1101 * 16 / 989e12, rel=1e-9)
