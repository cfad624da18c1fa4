"""The port's measurement tools on the CPU (their plain versions; no time
here is a device time):

* gallery_bench.make_stages at 32^2, gallery 64, batch 2, f32, with the
  JAX package's StyleGAN random:0 and He-scaled ArcFace weights carried
  across (iresnet-18: the stages do not depend on the FRM's depth):
  ``embed`` against the JAX make_lat2embs (2e-5 of its largest value),
  ``matmul`` against the JAX sq_euclidean_matmul
  of the JAX embeddings (1e-4 of its largest value), ``refine`` equal to
  the JAX argmin_dist_refined winners, ``topk`` holding them, ``pret``
  the transpose of ``pre``; main's JSON lines and their cumulative
  deltas;
* tail_kernel_bench's bytes and FLOPs per layer, and per launch of each
  standalone pass, against a hand count
  (B = 128, bf16: activations, nb and packed weights 2 bytes, the affine,
  coefs, ToRGB weights and sums 4 bytes; 2 FLOPs per multiply-add), the
  bound from them at the H100's 3.35 TB/s and 989 TFLOP/s, its JSON
  schema from one tiny case, and the ValueError of a layer outside the
  1024^2 tail's ladder.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import iresnet as jir
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.models.pipeline import make_lat2embs
from certifyingfacerecognition_tpu.ops import distances as jD
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch.models import iresnet as tiresnet
from certifyingfacerecognition_torch.tools import gallery_bench as GB
from certifyingfacerecognition_torch.tools import tail_kernel_bench as TB
from certifyingfacerecognition_torch.utils import weights as tw

RES = 32
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stages():
    """The port's stages on the JAX weights, the latents, the gallery
    (random rows at the embeddings' norm, with rows 10 and 40 within 1e-3
    of the two latents' JAX embeddings) and the JAX embeddings."""
    jgen = jsg.random_params(RES, seed=0)
    jfrm = jir.convert_torch_state_dict(jir.random_torch_style_state_dict(
        "iresnet18", seed=0, realistic=True), "iresnet18")
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 512)).astype(np.float32)
    jembs = np.asarray(make_lat2embs("insightface", RES)(
        jgen, jfrm, jnp.asarray(w)), np.float32)
    norm = float(np.linalg.norm(jembs, axis=1).mean())
    gallery = (rng.standard_normal((64, 512)) * norm / np.sqrt(512)).astype(
        np.float32)
    for row, e in zip((10, 40), jembs):
        gallery[row] = e * (1 + 1e-3 * rng.standard_normal(512))
    fns = GB.make_stages(tw.params_from_jax(jw.flatten_params(jgen), "cpu"),
                         tw.params_from_jax(jw.flatten_params(jfrm), "cpu"),
                         torch.tensor(gallery), RES, torch.float32, "cpu")
    return fns, torch.tensor(w), gallery, jembs


def test_gallery_stages_match_jax(stages):
    fns, w, gallery, jembs = stages
    assert sorted(fns) == sorted(GB.STAGES)
    embs = fns["embed"](w).numpy()
    np.testing.assert_allclose(embs, jembs, rtol=0,
                               atol=2e-5 * np.abs(jembs).max())
    d2 = np.asarray(jD.sq_euclidean_matmul(jnp.asarray(jembs),
                                           jnp.asarray(gallery)))
    for name in ("matmul", "matmul_high"):
        np.testing.assert_allclose(fns[name](w).numpy(), d2, rtol=0,
                                   atol=1e-4 * np.abs(d2).max())
    want = np.asarray(jD.argmin_dist_refined(
        jnp.asarray(jembs), jnp.asarray(gallery), "insightface"))
    np.testing.assert_array_equal(want, [10, 40])
    np.testing.assert_array_equal(fns["refine"](w).numpy(), want)
    topk = fns["topk"](w).numpy()
    assert topk.shape == (2, 8) and all(want[i] in topk[i] for i in range(2))
    pre, pret = fns["pre"](w), fns["pret"](w)
    assert pre.shape == (2, 512, RES, RES)
    torch.testing.assert_close(pret, pre.permute(2, 3, 1, 0), rtol=0, atol=0)
    img = fns["synth"](w)
    assert img.shape == (2, 3, RES, RES) and float(img.min()) >= 0.0
    assert fns["resize"](w).shape == (2, 3, 112, 112)


def test_gallery_bench_main_lines(monkeypatch, capsys):
    """main at 16^2: one JSON line per stage, deltas cumulative."""
    monkeypatch.setattr(GB, "bench_weights", lambda res, device: (
        tw.load_generator_params("random:0", resolution=res, device=device),
        tiresnet.convert_torch_state_dict(
            tiresnet.random_torch_style_state_dict("iresnet18", seed=0,
                                                   realistic=True),
            "iresnet18", device=device)))
    GB.main(["--gallery", "16", "--batch", "2", "--resolution", "16",
             "--reps", "1", "--injit", "2", "--stages", "pre,embed,refine",
             "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["stage"] for x in lines] == ["pre", "embed", "refine"]
    prev = 0.0
    for x in lines:
        assert sorted(x) == ["delta_ms", "device", "ms_per_batch",
                             "samples_per_sec", "stage"]
        assert x["device"] == "cpu" and x["ms_per_batch"] >= 0
        assert x["delta_ms"] == pytest.approx(x["ms_per_batch"] - prev)
        prev = x["ms_per_batch"]


B = 128
# (bytes read, bytes written, multiply-adds) of one launch, by hand
UP512 = (256 * 256 * 64 * B * 2 + 4 * 4 * 64 * 32 * 2 + 512 * 512 * 32 * 2
         + 2 * 64 * B * 4,
         512 * 512 * 32 * B * 2 + 2 * 32 * B * 4,
         512 * 512 * B * 2 * 2 * 64 * 32)
CONV512 = (512 * 512 * 32 * B * 2 + 3 * 3 * 32 * 32 * 2 + 512 * 512 * 32 * 2
           + 2 * 32 * B * 4,
           512 * 512 * 32 * B * 2 + 2 * 32 * B * 4,
           512 * 512 * B * 3 * 3 * 32 * 32)
UP1024 = (512 * 512 * 32 * B * 2 + 4 * 4 * 32 * 16 * 2
          + 1024 * 1024 * 16 * 2 + 2 * 32 * B * 4,
          1024 * 1024 * 16 * B * 2 + 2 * 16 * B * 4,
          1024 * 1024 * B * 2 * 2 * 32 * 16)
STATS1024 = (1024 * 1024 * 16 * B * 2 + 3 * 3 * 16 * 16 * 2
             + 1024 * 1024 * 16 * 2 + 2 * 16 * B * 4,
             2 * 16 * B * 4,
             1024 * 1024 * B * 3 * 3 * 16 * 16)
APPLY1024 = (STATS1024[0] + 2 * 16 * B * 4 + 16 * 3 * 4 + 3 * 4,
             3 * 1024 * 1024 * B * 2,
             STATS1024[2] + 1024 * 1024 * B * 16 * 3)
UP128 = (64 * 64 * 256 * B * 2 + 4 * 4 * 256 * 128 * 2
         + 128 * 128 * 128 * 2 + 2 * 256 * B * 4,
         128 * 128 * 128 * B * 2 + 2 * 128 * B * 4,
         128 * 128 * B * 2 * 2 * 256 * 128)
CONV256 = (256 * 256 * 64 * B * 2 + 3 * 3 * 64 * 64 * 2 + 256 * 256 * 64 * 2
           + 2 * 64 * B * 4,
           256 * 256 * 64 * B * 2 + 2 * 64 * B * 4,
           256 * 256 * B * 3 * 3 * 64 * 64)
HAND = {"up512": [UP512], "conv512": [CONV512], "up1024": [UP1024],
        "rgb1024": [STATS1024, APPLY1024], "rgbstats1024": [STATS1024],
        "rgbapply1024": [APPLY1024],
        "chain": [UP512, CONV512, UP1024, STATS1024, APPLY1024],
        "up128": [UP128], "conv256": [CONV256]}


@pytest.mark.parametrize("name", sorted(HAND))
def test_tail_bench_counts(name):
    read, write, macs = (sum(x) for x in zip(*HAND[name]))
    cost = TB.layer_cost(name, B)
    assert (cost["bytes_read"], cost["bytes_written"]) == (read, write)
    assert cost["flops"] == 2 * macs
    t_bytes, t_ops = (read + write) / 3.35e12 * 1e3, 2 * macs / 989e12 * 1e3
    assert cost["bound_ms"] == pytest.approx(max(t_bytes, t_ops))
    assert cost["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")


# the standalone passes: no input affine; a stats pass writes its sums, an
# apply pass reads the coefs and writes its activation (or the RGB image)
UP_NO_AFF = UP512[0] - 2 * 64 * B * 4
CONV_NO_AFF = CONV512[0] - 2 * 32 * B * 4
STANDALONE = {
    "up_stats": (256, 64, 32, (UP_NO_AFF, 2 * 32 * B * 4, UP512[2])),
    "up_apply": (256, 64, 32, (UP_NO_AFF + 2 * 32 * B * 4,
                               512 * 512 * 32 * B * 2, UP512[2])),
    "conv_stats": (512, 32, 32, (CONV_NO_AFF, 2 * 32 * B * 4, CONV512[2])),
    "conv_apply": (512, 32, 32, (CONV_NO_AFF + 2 * 32 * B * 4,
                                 512 * 512 * 32 * B * 2, CONV512[2])),
    "conv_rgb_apply": (1024, 16, 16, (APPLY1024[0] - 2 * 16 * B * 4,
                                      *APPLY1024[1:]))}


@pytest.mark.parametrize("name", sorted(STANDALONE))
def test_kernel_cost_standalone(name):
    h, ci, co, (read, write, macs) = STANDALONE[name]
    assert TB.kernel_cost(name, h, ci, co, B) == (read, write, 2 * macs)


def test_tail_bench_json_schema(capsys):
    TB.main(["--batch", "1", "--layers", "conv128", "--reps", "1",
             "--device", "cpu"])
    (line,) = capsys.readouterr().out.splitlines()
    rec = json.loads(line)
    assert sorted(rec) == ["batch", "bound_by", "bound_ms", "device",
                           "dtype", "finite", "layer", "ms", "x_bound"]
    assert rec["layer"] == "conv128" and rec["device"] == "cpu"
    assert rec["finite"] is True and rec["dtype"] == "bfloat16"
    assert rec["bound_ms"] == pytest.approx(
        TB.layer_cost("conv128", 1)["bound_ms"])
    assert rec["x_bound"] == pytest.approx(rec["ms"] / rec["bound_ms"])
    with pytest.raises(ValueError, match="up64"):
        TB.build_case("up64", 1, device="cpu")
