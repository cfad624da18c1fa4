"""The port's StyleGAN (certifyingfacerecognition_torch.models.stylegan)
against the JAX package's, same weights (carried across with
params_from_jax) and same latents, on the CPU. The port returns NCHW, the
JAX package NHWC.

Tolerances: f32 rtol=atol=1e-4 on [0, 1] images (measured worst case
1.8e-5 at 128^2). bf16: the two frameworks round the plain-op blocks at
different points (XLA on the CPU keeps excess f32 precision between
fused bf16 ops), so the port is held to the JAX bf16 output by its mean
absolute difference (< 1.5e-2; measured 0.0073) and to the f32 truth no
worse than 1.25x the JAX bf16 path's own mean error (measured 1.04x).

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch.models import stylegan as tsg
from certifyingfacerecognition_torch.utils import weights as tw

torch.set_num_threads(1)


def _setup(resolution, seed=3):
    jp = jsg.random_params(resolution, seed=seed)
    tp = tw.params_from_jax(jw.flatten_params(jp), device="cpu")
    w = np.random.default_rng(7).standard_normal((2, 512)).astype(np.float32)
    return jp, tp, w


def _port(tp, w, resolution, dtype=torch.float32):
    img = tsg.synthesize_from_w(tp, torch.tensor(w), resolution=resolution,
                                dtype=dtype)
    return img.float().permute(0, 2, 3, 1).numpy()


def _jax(jp, w, resolution, dtype=jnp.float32):
    return np.asarray(jsg.synthesize_from_w(jp, jnp.asarray(w),
                                            resolution=resolution,
                                            dtype=dtype), np.float32)


@pytest.mark.parametrize("resolution", [32, 128])
def test_synthesize_f32_matches_jax(resolution, monkeypatch):
    monkeypatch.delenv("CFR_TAIL", raising=False)
    jp, tp, w = _setup(resolution)
    np.testing.assert_allclose(_port(tp, w, resolution),
                               _jax(jp, w, resolution), rtol=1e-4, atol=1e-4)


def test_mapping_and_truncation_f32_match_jax():
    jp, tp, _ = _setup(32)
    z = np.random.default_rng(8).standard_normal((3, 512)).astype(np.float32)
    wj = jsg.mapping_apply(jp, jnp.asarray(z))
    wt = tsg.mapping_apply(tp, torch.tensor(z))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        tsg.truncation_apply(tp, wt, resolution=32).numpy(),
        np.asarray(jsg.truncation_apply(jp, wj, resolution=32)),
        rtol=1e-4, atol=1e-4)


def _bf16_close(port16, jax16, truth):
    assert np.abs(port16 - jax16).mean() < 1.5e-2
    assert np.abs(port16 - truth).mean() <= \
        1.25 * np.abs(jax16 - truth).mean() + 1e-4


def test_synthesize_bf16_plain_matches_jax(monkeypatch):
    monkeypatch.delenv("CFR_TAIL", raising=False)
    jp, tp, w = _setup(32)
    _bf16_close(_port(tp, w, 32, torch.bfloat16), _jax(jp, w, 32,
                                                         jnp.bfloat16),
                _jax(jp, w, 32))


@pytest.mark.slow
def test_synthesize_bf16_chain_tail_matches_jax(monkeypatch):
    """CFR_TAIL=bc with the cut at 128^2: the 128^2 block runs as the chain
    tail in both packages (plain versions here, Pallas interpret there)."""
    jp, tp, w = _setup(128)
    monkeypatch.delenv("CFR_TAIL", raising=False)
    truth = _jax(jp, w, 128)
    monkeypatch.setenv("CFR_TAIL", "bc")
    monkeypatch.setenv("CFR_TAIL_MIN_RES", "128")
    assert tsg.bc_tail_active(128, torch.bfloat16)
    _bf16_close(_port(tp, w, 128, torch.bfloat16),
                _jax(jp, w, 128, jnp.bfloat16), truth)


def _tail_syn(rng, h, channels, first):
    """Synthesis parameters of the tail blocks first..len(channels)-1 (as
    numpy) for an input of h x h pixels with channels[first-1] channels."""
    syn = {}
    for bi in range(first, len(channels)):
        ci, co = channels[bi - 1], channels[bi]
        h *= 2
        for li, kernel in ((2 * bi - 2, ("tconv_kernel", (4, 4, ci, co))),
                           (2 * bi - 1, ("conv_weight", (3, 3, co, co)))):
            syn[f"layer{li}"] = {
                kernel[0]: rng.standard_normal(kernel[1]) * 0.2,
                "noise": rng.standard_normal((h, h, 1)),
                "noise_weight": rng.standard_normal(co) * 0.1,
                "bias": rng.standard_normal(co) * 0.1,
                "style_weight": rng.standard_normal((512, 2 * co)),
                "style_bias": rng.standard_normal(2 * co) * 0.1}
    syn[f"output{len(channels) - 2}"] = {
        "conv_weight": rng.standard_normal((1, 1, channels[-1], 3)),
        "bias": rng.standard_normal(3) * 0.1}
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), syn)


def test_synthesis_tail_glue_matches_jax():
    """The small case of the test above: the port's _synthesis_tail_bc
    (styles, nb, folded weights, layout in and out) against the JAX
    package's on a one-block tail 16^2 -> 32^2 that starts at block 2
    (Pallas in interpret mode), f32 at the Pallas tests' 5e-4. The port's
    bf16 tail is held to that
    f32 image by its mean absolute difference: at most 2^-8 (one bf16 ulp)
    of the image's largest value (measured 0.0097 of 15.1, 2^-10.6; f32
    worst case 9.1e-6)."""
    rng = np.random.default_rng(5)
    channels, b = [32, 16, 8], 8
    syn = _tail_syn(rng, 16, channels, 2)
    x = rng.standard_normal((b, 16, 16, 16)).astype(np.float32)
    wp = rng.standard_normal((b, 4, 512)).astype(np.float32)
    kw = dict(bc_first=2, n_blocks=2, channels=channels)
    want = np.asarray(jsg._synthesis_tail_bc(
        jax.tree_util.tree_map(jnp.asarray, syn),
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(wp),
        dtype=jnp.float32, prec=jax.lax.Precision.HIGHEST, **kw))
    tsyn = tw.to_torch(syn, "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        got = tsg._synthesis_tail_bc(tsyn, torch.tensor(x).to(dtype),
                                     torch.tensor(wp).to(dtype),
                                     dtype=dtype, **kw)
        assert got.shape == (b, 3, 32, 32) and got.dtype == dtype
        got = got.float().permute(0, 2, 3, 1).numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
        else:
            assert np.abs(got - want).mean() <= 2.0 ** -8 * np.abs(want).max()


def test_bc_tail_f32_dtype_ignores_env(monkeypatch):
    """The f32 path stays on plain ops with CFR_TAIL=bc set."""
    _, tp, w = _setup(128, seed=2)
    monkeypatch.delenv("CFR_TAIL", raising=False)
    a = _port(tp, w, 128)
    monkeypatch.setenv("CFR_TAIL", "bc")
    monkeypatch.setenv("CFR_TAIL_MIN_RES", "128")
    assert not tsg.bc_tail_active(128, torch.float32)
    np.testing.assert_array_equal(a, _port(tp, w, 128))


def test_cb_out_without_chain_tail_raises(monkeypatch):
    """Only the chain tail emits the [3, H, W, B] image."""
    monkeypatch.delenv("CFR_TAIL", raising=False)
    _, tp, w = _setup(32)
    assert not tsg.cb_out_active(32, torch.bfloat16)
    with pytest.raises(ValueError, match="chain tail"):
        tsg.synthesize_from_w(tp, torch.tensor(w), resolution=32,
                              dtype=torch.bfloat16, cb_out=True)


def test_tail_cut_rules_match_jax(monkeypatch):
    for env in ({}, {"CFR_TAIL": "bc"},
                {"CFR_TAIL": "bc", "CFR_TAIL_MIN_RES": "64"},
                {"CFR_TAIL": "bc", "CFR_TAIL_MIN_RES": "256"}):
        for k in ("CFR_TAIL", "CFR_TAIL_MIN_RES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for res in (128, 256, 1024):
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
                assert tsg._bc_first_block(res, tdt) == \
                    jsg._bc_first_block(res, jdt)
                assert tsg.cb_out_active(res, tdt) == \
                    jsg.cb_out_active(res, jdt)


def test_block_checkpoints_keep_the_gradient(monkeypatch):
    """With grad enabled, a block whose input is >= 256^2 (the 512^2
    block here, 4 channels) runs each half-layer as its own checkpoint,
    the JAX package's remat discipline; the gradient with respect to the
    latents equals the one without checkpoints bit for bit, and with grad
    off nothing is checkpointed."""
    syn = tw.to_torch(_tail_syn(np.random.default_rng(9), 256, [4] * 9, 8),
                      "cpu")
    x = torch.tensor(np.random.default_rng(10).standard_normal(
        (1, 4, 256, 256)).astype(np.float32))
    wp = torch.tensor(np.random.default_rng(11).standard_normal(
        (1, 16, 512)).astype(np.float32))
    calls = []
    real = tsg.checkpoint
    monkeypatch.setattr(tsg, "checkpoint", lambda fn, *a, **k: (
        calls.append(1), real(fn, *a, **k))[1])

    def grad():
        w = wp.clone().requires_grad_()
        out = tsg._synthesis_block(syn, x, w, block_idx=8,
                                   dtype=torch.float32)
        assert out.shape == (1, 4, 512, 512)
        return torch.autograd.grad(out.square().sum(), w)[0]

    g = grad()
    assert len(calls) == 2
    with torch.no_grad():
        tsg._synthesis_block(syn, x, wp, block_idx=8, dtype=torch.float32)
    assert len(calls) == 2
    monkeypatch.setattr(tsg, "_remat", lambda fn, *a: fn(*a))
    torch.testing.assert_close(g, grad(), rtol=0, atol=0)
