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
* Each --attack-type of the AutoAttack family, --run-checks and a
  FaceNet run (one chunk of one identity, 1 iteration): the artifacts,
  every saved success re-verified by the port's exact predictor, the
  bounded attacks' deltas feasible, the check battery's result;
  --attack-type fab raises the JAX package's NotImplementedError.
* The flags that the port once refused: --mesh and --multihost (with
  --coordinator-address, --num-processes, --process-id) parse to the JAX
  parser's values and defaults, and --profile-dir writes a torch.profiler
  trace of the file's tiny in-process attack under its directory.

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
from certifyingfacerecognition_torch.attacks.checks import run_all_checks
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


# the AutoAttack family at the file's tiny size, one identity per chunk:
# 1 iteration, 1 restart, 2 targets, the presets at 1 iteration and 4
# Square queries
AA_FLAGS = ["--chunks", "4", "--batch-size", "1", "--iters", "1",
            "--restarts", "1", "--n-target-classes", "2",
            "--autoattack-iters", "1", "--square-queries", "4",
            "--apgd-use-cli-iters"]
BOUNDED = ("apgd-ce", "apgd-dlr", "apgd-t", "square")


@pytest.mark.parametrize("case", [
    ["--attack-type", "apgd-ce"], ["--attack-type", "apgd-dlr"],
    ["--attack-type", "apgd-t"], ["--attack-type", "fab-t"],
    ["--attack-type", "square"], ["--attack-type", "autoattack"],
    ["--attack-type", "autoattack-rand"],
    ["--attack-type", "autoattack-plus"],
    ["--attack-type", "autoattack", "--run-checks"],
    ["--attack-type", "apgd-t", "--face-recog-method", "facenet",
     "--frm-weights", "random:0"]],
    ids=["apgd-ce", "apgd-dlr", "apgd-t", "fab-t", "square", "autoattack",
         "autoattack-rand", "autoattack-plus", "run-checks", "facenet"])
def test_autoattack_family_cli(data_dir, tmp_path, monkeypatch, case):
    """One chunk of one identity, then --eval-files: the artifacts,
    every saved success re-verified through the port's exact predictor at
    the saved delta, the bounded attacks' deltas feasible (FAB-t's and the
    presets' are reported, not asserted), and --run-checks's battery in
    the chunk log."""
    checked = []
    monkeypatch.setattr(tcr, "run_all_checks", lambda *a, **k: checked.append(
        run_all_checks(*a, **k)))
    monkeypatch.chdir(tmp_path)
    d = tmp_path / "data"
    d.mkdir()
    for name in ("w.npy", "frm.npz"):
        (d / name).write_bytes(open(osp.join(data_dir, name), "rb").read())
    common = _common(str(d))
    common[common.index("--frm-weights") + 1] = str(d / "frm.npz")
    # logger names are process-wide: one output directory per case
    name = "aa" + "".join(case).replace(":", "")
    tmain.main(["--output-dir", name, "--num-chunk", "0"] + common + AA_FLAGS
               + case)
    method = case[case.index("--face-recog-method") + 1] \
        if "--face-recog-method" in case else "insightface"
    out = osp.join("exp_results", name)
    stats = artifacts.parse_chunk_log(osp.join(out, "logs",
                                               "results_chunk0of4.txt"))
    assert stats["instances"] == 1.0
    # a deterministic model with logits and live gradients passes every
    # check of the battery
    assert checked == ([{"randomized": False, "prob_output": False,
                         "zero_grad": False}] if "--run-checks" in case
                       else [])
    data_file = osp.join(out, "results", "results_chunk0of4.npz")
    n = int(stats["successes"])
    if n:
        data = artifacts.load_chunk_data(data_file)
        idx, deltas = data["successes"], data["deltas"]
        assert deltas.shape == (n, 5) and len(idx) == n
        region = tg.get_all_matrices(scale_factor=1e-4)
        if case[1] in BOUNDED:
            assert tg.in_ellps(torch.tensor(deltas), region.red_ellipse,
                               atol=1e-3)
        frm = (tw.load_params(str(d / "frm.npz"), device="cpu")
               if method == "insightface"
               else tw.load_frm_params("random:0", method, device="cpu"))
        params = {"gen": tw.load_generator_params("random", resolution=RES,
                                                  device="cpu"),
                  "frm": frm,
                  "gallery": torch.tensor(np.load(
                      d / f"embs_{method}.npz")["embs"])}
        w = np.load(d / "w.npy")[idx] + deltas @ region.dirs.numpy().T
        preds = tcr.make_predict_fn(method, RES)(params, torch.tensor(
            w.astype(np.float32))).numpy()
        assert np.all(preds != idx), (preds, idx)
    else:
        assert not osp.exists(data_file)
    tmain.main(["--output-dir", name, "--eval-files", "--scale-factor",
                "1e-4"])
    results = open(osp.join(out, "results.txt")).read().split("\n")
    assert results[1] == "instances:1"


def test_fab_untargeted_raises_as_jax(data_dir, tmp_path, monkeypatch):
    """--attack-type fab: the JAX package refuses untargeted FAB (one
    gradient per gallery class) when the attack runs, with
    NotImplementedError; the port's CLI does the same."""
    from certifyingfacerecognition_tpu.attacks import autoattack as jaa

    with pytest.raises(NotImplementedError) as want:
        jaa.run_attack(None, None, None, None, "fab")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError) as got:
        tmain.main(["--output-dir", "fab", "--num-chunk", "0",
                    "--attack-type", "fab"] + _common(data_dir))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flag", [
    ["--mesh"], ["--multihost"], ["--profile-dir", "trace"]])
def test_unported_flags_raise(data_dir, tmp_path, monkeypatch, flag):
    """Named for the refusal these three flags met before the port had
    parallel runs and profiling: now the group flags parse as the JAX
    CLI's (defaults included), and --profile-dir traces the attack."""
    from certifyingfacerecognition_tpu.cli import opts as jopts

    from certifyingfacerecognition_torch.cli import opts as topts

    names = ("mesh", "multihost", "coordinator_address", "num_processes",
             "process_id", "profile_dir")
    if flag[0] != "--profile-dir":
        group = ["--coordinator-address", "localhost:1234",
                 "--num-processes", "2", "--process-id", "1"]
        for argv in (["--output-dir", "x"],
                     ["--output-dir", "x"] + flag + group):
            want = jopts.build_parser().parse_args(argv)
            got = topts.build_parser().parse_args(argv)
            assert [getattr(got, n) for n in names] == \
                [getattr(want, n) for n in names]
        assert getattr(got, flag[0][2:]) is True
        return
    monkeypatch.chdir(tmp_path)
    tmain.main(["--output-dir", "prof", "--num-chunk", "0"]
               + _common(data_dir) + flag)
    traces = [f for f in os.listdir("trace") if f.endswith(".pt.trace.json")]
    assert len(traces) == 1, os.listdir("trace")
    text = open(osp.join("trace", traces[0])).read()
    assert "aten::conv2d" in text and "traceEvents" in text
    assert osp.isfile(osp.join("exp_results", "prof", "logs",
                               "results_chunk0of2.txt"))
