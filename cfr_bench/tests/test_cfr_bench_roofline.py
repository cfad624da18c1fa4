"""The roofline and FLOP counts against shapes worked by hand."""

import pytest

from cfr_bench import flops, harness, roofline

R50 = harness.load_json(harness.HERE / "configs"
                        / "stylegan-ffhq1024-arcface-r50.json")


def test_tail_layers_of_the_1024_model():
    assert roofline.tail_layers(1024) == [
        ("up", 256, 64, 32), ("conv", 512, 32, 32),
        ("up", 512, 32, 16), ("conv_rgb", 1024, 16, 16)]


def test_layer_work_by_hand():
    # conv 3x3 at 512^2, 32 -> 32, batch 100: input and output in bf16
    nbytes, fl = roofline.layer_work("conv", 512, 32, 32, 100)
    act = 512 * 512 * 32 * 100 * 2
    assert nbytes == act + 9 * 32 * 32 * 2 + 512 * 512 * 32 * 2 + act
    assert fl == 2.0 * 512 * 512 * 100 * 9 * 32 * 32
    # up 256^2 -> 512^2, 64 -> 32: 2x2 taps per output, plus the blur
    nbytes, fl = roofline.layer_work("up", 256, 64, 32, 1)
    assert nbytes == 2 * (256 * 256 * 64 + 16 * 64 * 32 + 512 * 512 * 32
                          + 512 * 512 * 32)
    assert fl == 2.0 * 512 * 512 * (4 * 64 * 32 + 32 * 9)


def test_tail_bound_is_bytes_bound_at_batch_100():
    ms, by = roofline.tail_bound_ms(1024, 100)
    assert by == "bytes"
    assert ms == pytest.approx(4.45, rel=0.02)


def test_share_refuses_nothing_measured():
    with pytest.raises(ValueError):
        roofline.share(0.0, roofline.PEAK_BF16)
    assert roofline.share(989e12 / 2, roofline.PEAK_BF16) == 50.0


def test_forward_flops_count_the_reference():
    # the 1024^2 synthesis dominates (the issue's 77.9 GFLOP per sample);
    # the gallery head adds 2 x 512 FLOPs a row
    total = flops.forward_flops(R50, 10000)
    assert 70e9 < total < 85e9
    more = flops.forward_flops(R50, 20000)
    assert more - total == 2 * 512 * 10000
    assert flops.forward_flops(dict(R50, resolution=32), 1) < total / 2
