"""The PGGAN CelebA-HQ family and its cell, pggan1024-r50.certify: the
family file's interface, its configuration's widths, the assumed mean of
the first convolution's weights, the cell end to end at 32^2 on the CPU
(correct, and not correct with each certify fault of faults.py, or with
the latent edit left out, in the timed path), the work of
synthesis.pggan_high and the FLOPs a sample counted by hand, the kernel
count of a span's calls, and a generator with no family file still
refused."""

import math

import numpy as np
import pytest
import torch

import conftest_helpers as H
from cfr_bench import faults, families, flops, harness, inputs, program, spans
from cfr_bench.reference import pggan
from cfr_bench.reference import pipeline as ref

CELL = "pggan1024-r50.certify"
CONFIG = harness.load_json(harness.HERE / "configs"
                           / "pggan-celebahq1024-arcface-r50.json")
GEN = families.load("generator", "progan_celebahq")
GEN_API = ("LATENT_DIM", "BOUNDARIES", "widths", "state_dict_specs",
           "synthesize", "latents", "to_program", "region", "pipeline",
           "dists_fn", "stages")


def test_family_file_has_the_interface():
    assert all(hasattr(GEN, a) for a in GEN_API)
    assert GEN.LATENT_DIM == 512 and len(GEN.BOUNDARIES) == 5
    assert all((program.BOUNDARIES / f).is_file() for f in GEN.BOUNDARIES)
    assert GEN.stages(None, None) is None
    z = GEN.latents(4, 2 ** 40 + 3, torch.device("cpu"))
    assert z.shape == (4, 512)
    assert torch.equal(z, GEN.latents(4, 2 ** 40 + 3, torch.device("cpu")))


def test_widths_are_the_published_ones():
    assert GEN.widths(1024) == {"synthesis_layers": 18, "z_dim": 512,
                                "channels_max": 512, "channels_min": 16,
                                "torgb_resolution": 1024,
                                "z_sphere_radius": math.sqrt(512)}
    specs = {n: s for n, s, _, _ in GEN.state_dict_specs(1024)}
    assert specs["layer0.conv.weight"] == (512, 512, 4, 4)
    assert specs["layer16.conv.weight"] == (16, 32, 3, 3)
    assert specs["layer17.conv.weight"] == (16, 16, 3, 3)
    assert specs["output8.conv.weight"] == (3, 16, 1, 1)
    assert [pggan.layer_shape(li)[1] for li in range(18)] == \
        [512] * 8 + [256, 256, 128, 128, 64, 64, 32, 32, 16, 16]


@pytest.mark.parametrize("key", sorted(GEN.widths(1024)))
def test_check_widths_refuses_a_changed_width(key):
    frm = families.load("frm", CONFIG["frm_arch"])
    ref.check_widths(CONFIG, GEN, frm)
    with pytest.raises(ValueError, match=key):
        ref.check_widths(dict(CONFIG, **{key: 2 * CONFIG[key]}), GEN, frm)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(trace):
    res = H.run_tiny(CELL, trace=trace)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    want = {m["name"] for m in harness.cell_metrics(
        H.bench(), "per_layer" if trace else "end_to_end", CELL)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == {"setup_s", "certify_samples_per_s",
                                       "certify_batch_ms_p95"}
    else:
        # no device trace on the CPU: the span readers find nothing
        assert set(res["metrics"]) == {"certify.mfu.pggan",
                                       "device.idle_share.certify.pggan"}
        assert 0 < res["metrics"]["certify.mfu.pggan"]["value"] < 100


def edit_ignored(patch):
    """The latent edit left out: every sample embeds the identity's own
    latent, as a certifier that never applies p would."""
    from certifyingfacerecognition_torch.ops import geometry as G

    patch(G, "matmul_f32", lambda p, dirs: torch.zeros(
        (p.shape[0], dirs.shape[1]), dtype=p.dtype, device=p.device))


# at 32^2 in float32 emb_err sees a row handed out twice, or a sample
# embedded without its edit; the chip's readings at 1024^2 in bf16 are in
# PERF.md, section 2
CERTIFY_FAULTS = [("alter_answers", "head_miss"), ("half_batch", "emb_err"),
                  ("still_noise", "noise_z"), ("half_counted", "cert_miss"),
                  ("edit_ignored", "emb_err")]
FAULTS = dict(faults.FAULTS, edit_ignored=edit_ignored)


@pytest.mark.parametrize("fault,number", CERTIFY_FAULTS,
                         ids=[f for f, _ in CERTIFY_FAULTS])
def test_broken_path_is_not_correct(fault, number, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    res = H.run_tiny(CELL)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"]


def test_first_convolution_steered_along_the_boundaries():
    b = ref.directions(program.BOUNDARIES, GEN.BOUNDARIES)       # [5, 512]
    mean = GEN.layer0_mean()
    assert mean.shape == (512, 512) and mean.dtype == np.float32
    np.testing.assert_allclose(mean, 2.0 * 512 / math.sqrt(5) * b.T @ b,
                               rtol=1e-6, atol=1e-6)
    # the mean maps a latent's part outside the boundaries' span to 0
    z = np.random.default_rng(0).standard_normal(512)
    rest = z - b.T @ np.linalg.lstsq(b.T, z, rcond=None)[0]
    assert np.abs(mean @ rest).max() < 1e-4 * np.abs(mean @ z).max()
    # the reference and the program's converter take the same weights
    sd = {"layer0.conv.weight": torch.ones((512, 512, 4, 4)),
          "layer0.wscale.bias": torch.zeros(512)}
    got = GEN.steered(sd)
    assert torch.equal(got["layer0.conv.weight"][:, :, 2, 3],
                       1.0 + torch.as_tensor(mean))
    assert got["layer0.wscale.bias"] is sd["layer0.wscale.bias"]
    got_np = GEN.steered({k: v.numpy() for k, v in sd.items()})
    np.testing.assert_array_equal(got_np["layer0.conv.weight"],
                                  got["layer0.conv.weight"].numpy())
    assert torch.equal(sd["layer0.conv.weight"], torch.ones((512, 512, 4, 4)))


def test_high_work_by_hand():
    b = 100
    act = {r: r * r * b for r in (256, 512, 1024)}
    nbytes = 2 * (
        act[256] * 64 + 16 * 64 * 32 + 32 + act[512] * 32      # up 512
        + act[512] * 32 + 9 * 32 * 32 + 32 + act[512] * 32     # conv 512
        + act[512] * 32 + 16 * 32 * 16 + 16 + act[1024] * 16  # up 1024
        + act[1024] * 16 + 9 * 16 * 16 + 16 + act[1024] * 16  # conv 1024
        + act[1024] * 16 + 16 * 3 + 3 + act[1024] * 3)        # ToRGB
    fl = 2.0 * (act[512] * 4 * 64 * 32 + act[512] * 9 * 32 * 32
                + act[1024] * 4 * 32 * 16 + act[1024] * 9 * 16 * 16
                + act[1024] * 16 * 3)
    assert GEN.high_work(1024, b) == (nbytes, fl)
    assert nbytes == 21_600_770_854 and fl == 1_835_427_430_400
    # bytes bound it: 6.45 ms at 3.35 TB/s against 1.86 ms at 989 TFLOP/s
    assert GEN.high_bound_ms(1024, b) == pytest.approx(1e3 * nbytes / 3.35e12)
    assert GEN.high_layers(256) == [] and GEN.high_work(32, b)[0] == 0


def test_forward_flops_at_1024():
    # the reference's synthesis (85.47 GFLOP: nearest-upsampled 3x3
    # convs), the resize, ArcFace r50 and the distances to 10k rows
    assert flops.forward_flops(CONFIG, 10000) == 98100428800.0


def test_kernels_per_batch_counts_the_span_calls_kernels(monkeypatch):
    # two calls on the snapshot's clock, kernels on the trace's (us from a
    # base three steps before): two kernels in the first call, three in
    # the second, one between and one after
    step = spans.TRACE_BASE_S * 10 ** 9
    t = 3 * step + 1_234_567_890_123
    snap = {"synthesis.pggan_high": {
        "calls": 2, "device_ns": [(t, t + 5_000_000),
                                  (t + 8_000_000, t + 13_000_000)]}}
    us = (t - 3 * step) / 1e3
    kernels = [("a", us + 500, 1000), ("b", us + 2000, 2000),
               ("gap", us + 6000, 1500), ("c", us + 8500, 2000),
               ("d", us + 11_000, 1000), ("e", us + 12_500, 200),
               ("late", us + 15000, 100)]
    read = harness.load_module(harness.HERE / "metrics"
                               / "pggan_high.kernels_per_batch.py").read
    monkeypatch.setattr(spans, "spans",
                        lambda rec, kind: snap if kind == "certify" else None)
    rec = {"kind": "certify", "kernels": kernels}
    assert read(rec) == 2.5
    assert read({"kind": "certify", "kernels": []}) is None
    snap["synthesis.pggan_high"]["device_ns"] = []
    assert read(rec) is None


def test_unknown_generator_refused_before_weights(monkeypatch):
    drawn = []
    monkeypatch.setattr(inputs, "state_dict",
                        lambda *a, **k: drawn.append(a))
    ctx, _ = H.tiny_cell(CELL)
    ctx.config = dict(ctx.config, generator="biggan_imagenet")
    with pytest.raises(ValueError,
                       match="progan_celebahq, stylegan_ffhq") as err:
        program.build(ctx)
    assert "'biggan_imagenet'" in str(err.value) and not drawn
