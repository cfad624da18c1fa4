"""PGGAN through the port's certify and attack path, on the CPU, against the
benchmark's plain reference (cfr_bench/reference/pggan.py: float32, NCHW,
written from the paper's equations; it imports nothing of the port):

* the f32 synthesis at 32^2 and 64^2 (the Z normalisation, 8 or 10
  pixel-normed convolutions, the ToRGB head) and, at 32^2, FacePipeline's
  embeddings through ArcFace iresnet-50 (cfr_bench/reference/iresnet.py),
  on seeded random weights of the references' state-dict specs;
* predict, make_dists_fn's distances and the gradient of a loss of them
  with respect to the perturbation p (with and without the checkpoint)
  against autograd through the reference;
* the region matrices from InterFaceGAN's Z-space boundary files against
  a NumPy computation;
* cfr-certify-torch and cfr-attack-torch with --model-name
  pggan_celebahq at 16^2 on data from cfr-generate-data-torch -m
  pggan_celebahq, and their refusal of StyleGAN-only options;
* the StyleGAN default unchanged: every entry point without a generator
  computes what it computes with generator="stylegan_ffhq".

Tolerances: the reference and the port both compute in float32 (TF32 off
on a card; none here) and differ in the order of their sums and in the
port's f32 up layer (nearest 2x, then the 3x3 conv, as the reference);
the largest differences read on this CPU are about 1e-6 of the images'
scale and 2e-6 of an embedding's norm, and the tolerances sit ten times
above them and far under bfloat16's 4e-3 rounding of one operand."""

import os.path as osp
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cfr_bench.reference import iresnet as rir
from cfr_bench.reference import pggan as rpg
from cfr_bench.reference import pipeline as ref
from cfr_bench.reference.precision import F32
from certifyingfacerecognition_torch.cli import certify as tcli
from certifyingfacerecognition_torch.cli import generate_data as tgen
from certifyingfacerecognition_torch.cli import main_attack as tmain
from certifyingfacerecognition_torch.constants import ATTRS, MODEL_POOL
from certifyingfacerecognition_torch.eval import artifacts
from certifyingfacerecognition_torch.eval.chunk_runner import (make_dists_fn,
                                                               make_predict_fn)
from certifyingfacerecognition_torch.models import iresnet, pggan, stylegan
from certifyingfacerecognition_torch.models.pipeline import (FacePipeline,
                                                             make_lat2embs,
                                                             synthesize)
from certifyingfacerecognition_torch.ops import geometry as G
from certifyingfacerecognition_torch.utils import weights as W

GEN = "pggan_celebahq"
SEED = 2 ** 31 + 11
CPU = torch.device("cpu")
BOUNDARIES = G.default_boundaries_dir()
BOUNDARY_FILES = [f"pggan_celebahq_{a}_boundary.npy" for a in ATTRS]
# the references as cfr_bench/reference/pipeline.embed takes them
GEN_REF = SimpleNamespace(synthesize=rpg.synthesize)
FRM_REF = SimpleNamespace(INPUT=112, embed=lambda sd, x, prec: rir.embed(
    sd, x, "iresnet50", prec=prec))
torch.set_num_threads(1)


def _draw(specs, seed: int) -> dict:
    """Tensors of a reference's ``specs`` ((name, shape, std, mean) each)
    from one seeded normal stream; running variances made positive."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, std, mean in specs:
        t = torch.randn(shape, generator=g) * std + mean
        out[name] = t.abs() if name.endswith("running_var") else t
    return out


def _numpy(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def _latents(n: int) -> torch.Tensor:
    return torch.randn((n, 512), generator=torch.Generator().manual_seed(SEED))


@pytest.fixture(scope="module")
def frm():
    """ArcFace iresnet-50: (state dict, the port's parameters)."""
    sd = _draw(rir.state_dict_specs("iresnet50"), SEED)
    return sd, iresnet.convert_torch_state_dict(_numpy(sd), "iresnet50",
                                                device=CPU)


@lru_cache(maxsize=2)
def _gen(res: int):
    """PGGAN at ``res``: (state dict, the port's parameters)."""
    sd = _draw(rpg.state_dict_specs(res), SEED + res)
    return sd, pggan.convert_torch_state_dict(_numpy(sd), res, device=CPU)


@pytest.fixture(scope="module", params=[32, 64])
def gen(request):
    """PGGAN at 32^2 or 64^2: (resolution, state dict, the port's
    parameters, one identity in Z)."""
    return (request.param, *_gen(request.param), _latents(1))


def _region():
    return G.get_all_matrices(boundaries_dir=BOUNDARIES, model_name=GEN)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def test_synthesis_matches_reference(gen):
    res, sd, params, z = gen
    raw = pggan.apply(params, pggan.preprocess_z(z), resolution=res)
    want = rpg.synthesis(sd, rpg.normalize_z(z), res)
    assert raw.shape == want.shape == (len(z), 3, res, res)
    assert float((raw - want).abs().max()) < 1e-5 * max(
        1.0, float(want.abs().max()))
    if res == 32:
        img = synthesize(GEN, params, z, resolution=res)
        assert torch.equal(img, stylegan.postprocess(raw))
        assert float((img - rpg.synthesize(sd, z, res)).abs().max()) < 1e-5


def test_pipeline_embeddings_match_reference(frm):
    res, z = 32, _latents(1)
    sd, params = _gen(res)
    fsd, fparams = frm
    pipe = FacePipeline(params, fparams, dirs=_region().dirs.t(),
                        resolution=res, device="cpu", generator=GEN)
    got = pipe.lat2embs(z)
    want = ref.embed(GEN_REF, sd, FRM_REF, fsd, z, res, F32)
    assert got.shape == want.shape == (len(z), 512)
    assert _rel(got, want) < 2e-5


WEIGHT = torch.linspace(-1.0, 1.0, 3, dtype=torch.float64)


@pytest.fixture(scope="module")
def gallery_case(frm):
    """32^2: the port's FacePipeline over a gallery of the reference's
    embeddings of three identities, two perturbations p of identity 0, and
    the reference's distances of z_0 + p @ dirs (in float64) to the
    gallery, with the gradient of loss(p) = sum_j WEIGHT_j d_0j (the first
    perturbation's weighted distances) by autograd."""
    fsd, fparams = frm
    sd, params = _gen(32)
    z = _latents(3)
    g = ref.embed(GEN_REF, sd, FRM_REF, fsd, z, 32, F32)
    pipe = FacePipeline(params, fparams, dirs=_region().dirs.t(),
                        resolution=32, gallery=g, device="cpu", generator=GEN)
    dirs = torch.as_tensor(ref.directions(BOUNDARIES, BOUNDARY_FILES))
    p = torch.randn((2, 5), generator=torch.Generator().manual_seed(3)) * 3.0
    p_ref = p.clone().requires_grad_(True)
    e = ref.embed(GEN_REF, sd, FRM_REF, fsd,
                  z[0] + (p_ref.double() @ dirs).float(), 32, F32)
    d_ref = ref.distances("insightface", e, g)
    (d_ref[0] * WEIGHT).sum().backward()
    return {"pipe": pipe, "z": z, "p": p, "dirs": dirs,
            "d_ref": d_ref.detach(), "grad_ref": p_ref.grad[:1]}


def test_predict_matches_reference(gallery_case):
    c = gallery_case
    pipe = c["pipe"]
    got = pipe.predict(c["z"][0], c["p"])
    assert got.tolist() == c["d_ref"].argmin(1).tolist()
    # the certify path's function, and the attack's predictor, each on one
    # perturbation
    params = {"gen": pipe.gen_params, "frm": pipe.frm_params,
              "gallery": pipe.gallery}
    w = pipe.perturb_latents(c["z"][0], c["p"][:1])
    assert make_predict_fn("insightface", 32, generator=GEN)(
        params, w).tolist() == got[:1].tolist()
    fn, fparams = pipe.predict_fn_with_params()
    assert fn(fparams, c["z"][0], c["p"][1:]).tolist() == got[1:].tolist()


@pytest.mark.parametrize("remat", [True, False])
def test_dists_and_gradient_match_reference(gallery_case, remat):
    c = gallery_case
    pipe = c["pipe"]
    params = {"gen": pipe.gen_params, "frm": pipe.frm_params,
              "gallery": pipe.gallery}
    dists = make_dists_fn("insightface", 32, remat=remat, generator=GEN)
    # from the reference's latents (z_0 + p @ dirs in float64): the loss is
    # piecewise smooth (the postprocess's clamp, leaky ReLU, PReLU), and
    # where the two float32 computations round a value to either side of a
    # kink, p's gradient moves by a term of the sum: 1.1e-3 of its largest
    # value at most in the runs read (on one side of every kink the
    # reference in float32 reads 4.3e-5 of it against itself in float64);
    # a term left out or a wrong factor moves it by far more
    p = c["p"][:1].clone().requires_grad_(True)
    d = dists(params, c["z"][0] + (p.double() @ c["dirs"]).float())
    (d[0].double() * WEIGHT).sum().backward()
    d_ref, grad_ref = c["d_ref"][:1], c["grad_ref"]
    assert float((d.detach().double() - d_ref).abs().max()) < 2e-5 * float(
        d_ref.abs().max())
    assert float((p.grad - grad_ref).abs().max()) < 1e-2 * float(
        grad_ref.abs().max())


def test_region_matrices_from_z_files():
    region = _region()
    dirs = np.concatenate([np.load(osp.join(BOUNDARIES, f))
                           for f in BOUNDARY_FILES]).T
    np.testing.assert_allclose(region.dirs.numpy(), dirs, atol=1e-7)
    np.testing.assert_allclose(region.proj_mat.numpy(),
                               dirs @ np.linalg.pinv(dirs), atol=1e-6)
    np.testing.assert_allclose(region.dirs_inv.numpy(), np.linalg.pinv(dirs),
                               atol=1e-6)
    np.testing.assert_allclose(region.red_ellipse_diag.numpy(),
                               ref.attribute_ellipse_diag(), rtol=1e-5)
    assert G.boundary_file("pggan", "celebahq", "age", "z") == \
        "pggan_celebahq_age_boundary.npy"


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """16^2: two PGGAN identities from cfr-generate-data-torch (z.npy),
    He-scaled iresnet-18 weights, and the gallery the certify CLI reads."""
    d = str(tmp_path_factory.mktemp("pggan_cli"))
    tgen.main(["-m", GEN, "-o", d, "-n", "2", "--resolution", "16",
               "--device", "cpu"])
    W.save_params(osp.join(d, "frm.npz"), iresnet.convert_state_dict_np(
        iresnet.random_torch_style_state_dict("iresnet18", seed=0,
                                              realistic=True), "iresnet18"))
    pipe = FacePipeline(W.load_generator_params("random", GEN, resolution=16,
                                                device="cpu"),
                        W.load_frm_params(osp.join(d, "frm.npz"),
                                          device="cpu"),
                        dirs=_region().dirs.t(), resolution=16, device="cpu",
                        generator=GEN)
    z = np.load(osp.join(d, "z.npy"))
    np.savez(osp.join(d, "embs_insightface.npz"),
             embs=pipe.lat2embs(z).numpy())
    return d


def _certify_argv(d, out, *extra):
    return ["--face-recog-model", "insightface", "--outfile", out,
            "--sigma", "0.001", "--data-dir", d, "--resolution", "16",
            "--frm-weights", osp.join(d, "frm.npz"), "--N0", "4", "--N",
            "12", "--batch-sz", "4", "--device", "cpu", "--model-name", GEN,
            *extra]


def test_certify_cli_pggan(cli_dir, tmp_path):
    out = str(tmp_path / "pg.tsv")
    tcli.main(_certify_argv(cli_dir, out))
    rows = [line.split("\t") for line in open(out).read().split("\n")[1:]
            if line]
    # sigma 0.001: every sample keeps its label, so each identity is
    # certified as itself with the gap of 12 of 12 samples (the fewest
    # whose Clopper-Pearson bound at alpha 0.001 passes 1/2)
    assert [r[:4] for r in rows] == [[str(i), str(i), str(i), "1"]
                                     for i in range(2)]
    _, gap = ref.certificate(np.zeros(4, np.int64), np.zeros(12, np.int64),
                             0, 0.001)
    assert [r[4] for r in rows] == [f"{gap:.3}"] * 2


def test_attack_cli_pggan(cli_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tmain.main(["--output-dir", "pg", "--num-chunk", "0", "--model-name",
                GEN, "--data-dir", cli_dir, "--chunks", "1", "--batch-size",
                "2", "--resolution", "16", "--iters", "1", "--restarts", "1",
                "--device", "cpu", "--frm-weights",
                osp.join(cli_dir, "frm.npz"), "--load-embs"])
    log = osp.join("exp_results", "pg", "logs", "results_chunk0of1.txt")
    assert artifacts.parse_chunk_log(log)["instances"] == 2.0


@pytest.mark.parametrize("cli,flags", [
    ("certify", ["--synthesis-resolution", "8"]),
    ("certify", ["--synthesis-resolution", "8", "--cascade"]),
    ("attack", ["--synthesis-resolution", "8"])])
def test_stylegan_only_options_refused(cli_dir, tmp_path, cli, flags):
    if cli == "certify":
        argv = _certify_argv(cli_dir, str(tmp_path / "x.tsv"), *flags)
        run = tcli.main
    else:
        argv = ["--output-dir", str(tmp_path / "x"), "--model-name", GEN,
                "--device", "cpu", "--data-dir", cli_dir, *flags]
        run = tmain.main
    with pytest.raises(SystemExit, match=f"StyleGAN's alone; {GEN}"):
        run(argv)
    assert not osp.exists(tmp_path / "x.tsv")


@pytest.fixture(scope="module")
def stylegan_case():
    """StyleGAN at 16^2, He-scaled iresnet-18, a latent in W and a
    gallery of four rows."""
    return {"gen": stylegan.random_params(16, seed=0, device="cpu"),
            "frm": iresnet.convert_torch_state_dict(
                iresnet.random_torch_style_state_dict(
                    "iresnet18", seed=0, realistic=True), "iresnet18",
                device="cpu"),
            "w": torch.randn((1, 512),
                             generator=torch.Generator().manual_seed(1)),
            "gallery": torch.randn((4, 512),
                                   generator=torch.Generator().manual_seed(2))}


@pytest.mark.parametrize("entry", ["make_lat2embs", "make_dists_fn",
                                   "FacePipeline", "synthesize",
                                   "get_all_matrices"])
def test_stylegan_default_unchanged(stylegan_case, entry):
    c = stylegan_case
    params, frm_params, w = c["gen"], c["frm"], c["w"]
    explicit = {"generator": "stylegan_ffhq"}
    if entry == "make_lat2embs":
        got = make_lat2embs("insightface", 16)(params, frm_params, w)
        want = make_lat2embs("insightface", 16, **explicit)(params,
                                                            frm_params, w)
    elif entry == "make_dists_fn":
        p = {"gen": params, "frm": frm_params, "gallery": c["gallery"]}
        got = make_dists_fn("insightface", 16)(p, w)
        want = make_dists_fn("insightface", 16, **explicit)(p, w)
    elif entry == "FacePipeline":
        pipe = FacePipeline(params, frm_params, dirs=torch.eye(5, 512),
                            resolution=16, gallery=c["gallery"],
                            device="cpu")
        assert pipe.generator == "stylegan_ffhq"
        got = pipe.lat2embs(w)
        want = make_lat2embs("insightface", 16)(params, frm_params, w)
    elif entry == "synthesize":
        got = synthesize("stylegan_ffhq", params, w, resolution=16)
        want = stylegan.synthesize_from_w(params, w, resolution=16)
    else:
        got = G.get_all_matrices().dirs
        want = G.get_all_matrices(model_name="stylegan_ffhq").dirs
        files = [osp.join(BOUNDARIES, f"stylegan_ffhq_{a}_w_boundary.npy")
                 for a in ATTRS]
        np.testing.assert_array_equal(
            got.numpy(), np.concatenate([np.load(f) for f in files]).T
            .astype(np.float32))
    assert torch.equal(got, want)


def test_unknown_generator_and_cb_out_refused():
    with pytest.raises(ValueError, match="known: " + ", ".join(MODEL_POOL)):
        make_lat2embs("insightface", 32, generator="biggan_imagenet")
    with pytest.raises(ValueError, match="StyleGAN chain tail"):
        synthesize(GEN, {}, torch.zeros((1, 512)), resolution=32,
                   cb_out=True)
