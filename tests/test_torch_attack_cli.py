"""The port's attack path against the JAX package's at resolution 16:
random StyleGAN weights and He-scaled ArcFace iresnet-18 weights, carried
across with params_from_jax (the default random:0 ArcFace weights drive
every embedding to NaN).

* make_dists_fn's distances (rtol 1e-4) and their gradient with respect
  to the latents, f32, against the JAX make_dists_fn: the gradient to
  5e-3 of its largest value. The reason for that bound: the two
  frameworks round differently in f32, and a pre-activation within f32
  rounding of 0 takes the other lrelu branch in one of them (its local
  derivative changes by 0.8), which moves every latent coordinate's
  gradient. At this seed one such element (|x| = 1.3e-6 at 16^2) gives
  the measured 5.0e-4; with the f64 run's branch decisions the port's f32
  gradient agrees with its f64 one to 2.7e-6.
* cfr-attack-torch --device cpu on 4 identities in 2 chunks, then
  --eval-files: the JAX CLI's artifact files and schema
  (tests/test_cli.py:61-75), feasible deltas, and the results.txt fields.
* --synthesis-resolution 8: the gallery is computed at 8^2 (equal to the
  JAX pipeline's at 8^2, rtol 1e-4), cached under embs_<method>_sr8.npz
  and read back from that name by --load-embs.
* The flags of unported parts exit with a message naming their ROADMAP
  item.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.eval import chunk_runner as jcr
from certifyingfacerecognition_tpu.models import iresnet as jir
from certifyingfacerecognition_tpu.models import pipeline as jpl
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch.cli import main_attack as tmain
from certifyingfacerecognition_torch.eval import artifacts
from certifyingfacerecognition_torch.eval import chunk_runner as tcr
from certifyingfacerecognition_torch.ops import geometry as tg
from certifyingfacerecognition_torch.utils import weights as tw

RES = 16
torch.set_num_threads(1)


def _frm():
    return jir.convert_torch_state_dict(
        jir.random_torch_style_state_dict("iresnet18", seed=0,
                                          realistic=True), "iresnet18")


def test_dists_fn_gradient_matches_jax():
    jgen, jfrm = jsg.random_params(RES, seed=2), _frm()
    rng = np.random.default_rng(0)
    gallery = rng.standard_normal((6, 512)).astype(np.float32)
    w = rng.standard_normal((2, 512)).astype(np.float32)
    cot = rng.standard_normal((2, 6)).astype(np.float32)
    jparams = {"gen": jgen, "frm": jfrm, "gallery": jnp.asarray(gallery)}
    jfn = jcr.make_dists_fn("insightface", RES)
    want, vjp = jax.vjp(lambda w: jfn(jparams, w), jnp.asarray(w))
    (gwant,) = vjp(jnp.asarray(cot))

    tparams = {"gen": tw.params_from_jax(jw.flatten_params(jgen), "cpu"),
               "frm": tw.params_from_jax(jw.flatten_params(jfrm), "cpu"),
               "gallery": torch.tensor(gallery)}
    wt = torch.tensor(w, requires_grad=True)
    got = tcr.make_dists_fn("insightface", RES)(tparams, wt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4)
    (g,) = torch.autograd.grad((got * torch.tensor(cot)).sum(), wt)
    gwant = np.asarray(gwant)
    assert np.abs(g.numpy() - gwant).max() <= 5e-3 * np.abs(gwant).max()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("attack")
    w = np.random.default_rng(1).standard_normal((4, 512)).astype(np.float32)
    np.save(osp.join(d, "w.npy"), w)
    jw.save_params(osp.join(d, "frm.npz"), _frm())
    return str(d)


def _common(data_dir):
    return ["--data-dir", data_dir, "--chunks", "2", "--batch-size", "2",
            "--resolution", str(RES), "--iters", "2", "--restarts", "1",
            "--seed", "1", "--scale-factor", "1e-4", "--device", "cpu",
            "--frm-weights", osp.join(data_dir, "frm.npz")]


def test_attack_chunks_and_eval_files(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = _common(data_dir)
    tmain.main(["--output-dir", "atk", "--num-chunk", "0"] + common)
    # chunk 1 reuses the cached embeddings
    tmain.main(["--output-dir", "atk", "--num-chunk", "1", "--load-embs"]
               + common)
    assert osp.isfile(osp.join(data_dir, "embs_insightface.npz"))
    out = osp.join("exp_results", "atk")
    logs = sorted(os.listdir(osp.join(out, "logs")))
    assert logs == ["results_chunk0of2.txt", "results_chunk1of2.txt"]
    stats = [artifacts.parse_chunk_log(osp.join(out, "logs", f))
             for f in logs]
    assert [sorted(s) for s in stats] == [["avg_mags", "instances",
                                           "successes"]] * 2
    assert [s["instances"] for s in stats] == [2.0, 2.0]

    # scale factor 1e-4: semi-axes 100x the attribute budgets, so that two
    # iterations at 16^2 find adversaries to re-verify and save
    region = tg.get_all_matrices(scale_factor=1e-4)
    n_data = 0
    for f in sorted(os.listdir(osp.join(out, "results"))):
        data = artifacts.load_chunk_data(osp.join(out, "results", f))
        assert sorted(data) == ["deltas", "magnitudes", "successes"]
        assert data["deltas"].shape == (len(data["successes"]), 5)
        assert np.all(data["magnitudes"] <= 1.0 + 1e-3)
        assert tg.in_ellps(torch.tensor(data["deltas"]), region.red_ellipse,
                           atol=1e-3)
        n_data += len(data["successes"])
    assert n_data == sum(int(s["successes"]) for s in stats)
    assert n_data > 0, "no adversary found: the test exercises nothing"

    tmain.main(["--output-dir", "atk", "--eval-files", "--scale-factor",
                "1e-4"])
    results = open(osp.join(out, "results.txt")).read().split("\n")
    fields = [line.split(":")[0] for line in results if line]
    assert fields[:4] == ["successes", "instances", "rate", "avg_mag"]
    assert results[1] == "instances:4"
    assert osp.isfile(osp.join(out, "figs", "acc_vs_pert.npz")) or \
        osp.isfile(osp.join(out, "figs", "acc_vs_pert.png"))


def test_synthesis_resolution_gallery_name(data_dir, tmp_path, monkeypatch):
    d = tmp_path / "data"
    d.mkdir()
    for name in ("w.npy", "frm.npz"):
        (d / name).write_bytes(open(osp.join(data_dir, name), "rb").read())
    monkeypatch.chdir(tmp_path)
    common = _common(str(d)) + ["--synthesis-resolution", "8", "--iters", "1"]
    common[common.index("--frm-weights") + 1] = str(d / "frm.npz")
    tmain.main(["--output-dir", "sr", "--num-chunk", "0"] + common)
    assert sorted(os.listdir(d)) == ["embs_insightface_sr8.npz", "frm.npz",
                                     "w.npy"]
    embs = np.load(d / "embs_insightface_sr8.npz")["embs"]
    jpipe = jpl.FacePipeline(jsg.random_params(RES, seed=0), _frm(),
                             dirs=jnp.asarray(tg.get_all_matrices().dirs.T),
                             resolution=8)
    w = np.load(d / "w.npy")
    np.testing.assert_allclose(embs, np.asarray(jpipe.lat2embs(
        jnp.asarray(w))), rtol=1e-4, atol=1e-4 * np.abs(embs).max())
    tmain.main(["--output-dir", "sr", "--num-chunk", "1", "--load-embs"]
               + common)
    assert sorted(os.listdir(osp.join("exp_results", "sr", "logs"))) == \
        ["results_chunk0of2.txt", "results_chunk1of2.txt"]


@pytest.mark.parametrize("flag", [
    ["--attack-type", "apgd-ce"], ["--attack-type", "autoattack"],
    ["--run-checks"], ["--mesh"], ["--multihost"],
    ["--face-recog-method", "facenet"],
    ["--profile-dir", "trace"], ["--n-target-classes", "3"]])
def test_unported_flags_raise(tmp_path, monkeypatch, flag):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="ROADMAP"):
        tmain.main(["--output-dir", "x", "--data-dir", str(tmp_path)]
                   + flag)
    assert not osp.exists("exp_results")
