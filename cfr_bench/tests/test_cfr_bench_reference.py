"""The plain reference against the program at 32^2 in float32 on the
CPU, and its statistics against scipy."""

import numpy as np
import pytest
import torch
from scipy.stats import beta, norm

from cfr_bench import families, inputs, program
from cfr_bench.reference import facenet, iresnet, pipeline, stylegan
from cfr_bench.reference.precision import F32, FP8

GEN = families.load("generator", "stylegan_ffhq")
FRMS = {"insightface": families.load("frm", "iresnet50"),
        "facenet": families.load("frm", "inception_resnet_v1")}


@pytest.fixture(scope="module")
def weights():
    dev = torch.device("cpu")
    return {"gen": inputs.generator_weights(GEN, 32, 5, dev),
            "insightface": inputs.frm_weights(FRMS["insightface"], 5, dev),
            "facenet": inputs.frm_weights(FRMS["facenet"], 5, dev),
            "w": GEN.latents(3, 5, dev)}


def test_stylegan_synthesis_matches_the_program(weights):
    from certifyingfacerecognition_torch.models import stylegan as P

    gen = P.convert_torch_state_dict(inputs.to_numpy(weights["gen"]), 32,
                                     device="cpu")
    want = P.synthesize_from_w(gen, weights["w"], resolution=32)
    got = stylegan.synthesize(weights["gen"], weights["w"], 32)
    assert got.shape == want.shape == (3, 3, 32, 32)
    assert float((got - want).abs().max()) < 2e-5


@pytest.mark.parametrize("frs", ["insightface", "facenet"])
def test_embeddings_match_the_program(weights, frs):
    from certifyingfacerecognition_torch.models import (facenet as PF,
                                                        iresnet as PI,
                                                        stylegan as PS)
    from certifyingfacerecognition_torch.models.pipeline import \
        make_lat2embs

    gen = PS.convert_torch_state_dict(inputs.to_numpy(weights["gen"]), 32,
                                      device="cpu")
    sd = inputs.to_numpy(weights[frs])
    frm = (PI.convert_torch_state_dict(sd, "iresnet50", device="cpu")
           if frs == "insightface" else
           PF.convert_torch_state_dict(sd, device="cpu"))
    want = make_lat2embs(frs, 32)(gen, frm, weights["w"])
    got = pipeline.embed(GEN, weights["gen"], FRMS[frs], weights[frs],
                         weights["w"], 32)
    assert float(program.rel_err(got, want).max()) < 1e-4


def test_float8_control_departs_from_float32(weights):
    e32 = pipeline.embed(GEN, weights["gen"], FRMS["insightface"],
                         weights["insightface"], weights["w"], 32, F32)
    e8 = pipeline.embed(GEN, weights["gen"], FRMS["insightface"],
                        weights["insightface"], weights["w"], 32, FP8)
    err = float(program.rel_err(e8, e32).max())
    assert 1e-2 < err < 1.0


@pytest.mark.parametrize("k,n", [(1, 10), (7, 10), (1990, 2000),
                                 (1999, 2000), (2000, 2000), (1000, 2000)])
def test_clopper_pearson_matches_scipy(k, n):
    got = pipeline.clopper_pearson_lower(k, n, 0.001)
    assert abs(got - beta.ppf(0.001, k, n - k + 1)) < 1e-12


def test_certificate_from_answers():
    pred, gap = pipeline.certificate(np.array([3, 3, 1]),
                                     np.full(2000, 3), 3, 0.001)
    assert pred == 3
    assert abs(gap - norm.ppf(0.001 ** (1 / 2000))) < 1e-12
    assert pipeline.certificate(np.array([1, 1, 3]), np.zeros(0, int), 3,
                                0.001) == (1, 0.0)
    assert pipeline.certificate(np.array([3]), np.array([3] * 10 + [0] * 10),
                                3, 0.001) == (-1, 0.0)


def test_ellipse_and_directions_match_the_program():
    from certifyingfacerecognition_torch.ops import geometry as G

    region = G.get_all_matrices(boundaries_dir=str(program.BOUNDARIES))
    np.testing.assert_array_equal(
        np.float32(pipeline.attribute_ellipse_diag()),
        region.red_ellipse_diag.numpy())
    np.testing.assert_array_equal(
        np.float32(pipeline.directions(program.BOUNDARIES, GEN.BOUNDARIES)),
        region.dirs.t().numpy())


def test_state_dict_layouts_are_the_checkpoints():
    names = {n for n, *_ in stylegan.state_dict_specs(1024)}
    assert "synthesis.layer17.conv.weight" in names
    assert "synthesis.layer16.weight" in names        # fused 1024^2 up-conv
    assert "synthesis.output8.conv.weight" in names
    shapes = {n: s for n, s, *_ in iresnet.state_dict_specs()}
    assert shapes["layer3.13.conv2.weight"] == (256, 256, 3, 3)
    assert shapes["fc.weight"] == (512, 512 * 49)
    shapes = {n: s for n, s, *_ in facenet.state_dict_specs()}
    assert shapes["repeat_2.9.branch1.1.conv.weight"] == (128, 128, 1, 7)
    assert shapes["last_linear.weight"] == (512, 1792)


def test_inputs_repeat_from_a_large_seed():
    seed = 2 ** 31 + 123456789
    a = GEN.latents(4, seed, torch.device("cpu"))
    b = GEN.latents(4, seed, torch.device("cpu"))
    c = GEN.latents(4, seed + 1, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("frs", ["insightface", "facenet-vggface2"])
def test_head_rounding_covers_the_float32_head(frs):
    # near ties: rows a float32 ulp or two apart, where the program's head
    # may pick either; its answer stays within the rounding allowed
    from certifyingfacerecognition_torch.ops.distances import \
        argmin_dist_refined

    gen = torch.Generator().manual_seed(3)
    e = torch.randn(64, 512, generator=gen) * 20
    g = torch.randn(300, 512, generator=gen) * 20
    g[1::2] = g[::2] + 1e-6 * torch.randn(150, 512, generator=gen)
    if frs != "insightface":
        e = e / e.norm(dim=1, keepdim=True)
        g = g / g.norm(dim=1, keepdim=True)
    g[:64] = e + 1e-3 * torch.randn(64, 512, generator=gen)
    g[64:128] = g[:64] + 1e-7 * torch.randn(64, 512, generator=gen)
    ans = argmin_dist_refined(e, g, frs)
    d = pipeline.distances(frs, e, g)
    best = d.min(1).values
    d_ans = d.gather(1, ans[:, None])[:, 0]
    assert bool((d_ans - best <= pipeline.head_rounding(
        frs, e, g, d_ans, best)).all())
    wrong = (ans + 1) % g.shape[0]
    d_wrong = d.gather(1, wrong[:, None])[:, 0]
    assert bool((d_wrong - best > pipeline.head_rounding(
        frs, e, g, d_wrong, best)).all())
