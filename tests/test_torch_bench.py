"""The port's headline benchmark (certifyingfacerecognition_torch/bench.py)
against the JAX package's bench.py, f32 on the CPU at 32^2 with full-width
models (StyleGAN, ArcFace iresnet-50 with He-scaled weights):

  * mc mode: with the JAX package's noise injected, the port's counts equal
    those of make_counts_fn built as bench.py builds it (its predict_fn,
    the same converted weights, gallery, directions and latent), exactly,
    at the bench's sigma 0.1 (every sample keeps class 0) and at sigma 300
    (the classes split); main() prints one JSON line with bench.py's keys
    and ``device``, after a warm-up and ``reps`` runs of n_batches x batch
    samples each;
  * --ab CFR_TAIL=,bc writes bench_ab_CFR_TAIL.json with bench.py's
    summary keys, the first value measured with the flag unset;
  * BENCH_MESH_ID=2 in two gloo processes (torchrun's environment), each
    holding one gallery row, counts as one process does;
  * attack mode: the gallery equals the JAX bench's construction
    (mapping_apply on the same z, then embed) to 1e-4 relative, with the
    embedding chunk cut from 128 to 3 so that 4 identities take a full
    and a ragged, zero-padded chunk; measure_attack runs PGD and FAB-t
    and every success re-verifies against make_predict_fn. The attack
    settings (PGD_KWARGS, FABT_KWARGS) are held to bench.py's call
    keywords, then cut to one iteration and one restart (FAB-t: one target
    class) for the run: a full 5 x 5 PGD at 32^2 takes about a minute on
    one CPU thread;
  * the module's top-level names and parameters include bench.py's.

The file runs in about 40 s alone on one thread (the gloo processes run
beside it), and about three times that in the whole suite's
loaded run."""

import ast
import json
import os
import os.path as osp
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import iresnet as jiresnet
from certifyingfacerecognition_tpu.models import stylegan as jstylegan
from certifyingfacerecognition_tpu.models.pipeline import \
    make_lat2embs as jmake_lat2embs
from certifyingfacerecognition_tpu.ops import distances as JD
from certifyingfacerecognition_tpu.smoothing import certificate as jcert
from certifyingfacerecognition_tpu.smoothing.smooth import make_counts_fn
from certifyingfacerecognition_torch import bench
from certifyingfacerecognition_torch.eval.chunk_runner import make_predict_fn
from certifyingfacerecognition_torch.ops import geometry as G

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RES, BATCH, N_BATCHES, N_GALLERY = 32, 2, 2, 4
TIMEOUT = 120
torch.set_num_threads(1)

ENV = {"BENCH_RESOLUTION": str(RES), "BENCH_BATCH": str(BATCH),
       "BENCH_NBATCHES": str(N_BATCHES), "BENCH_GALLERY": str(N_GALLERY),
       "BENCH_DTYPE": "fp32", "BENCH_FRS": "insightface",
       "BENCH_BATCH_ATTACK": "2"}
JSON_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}


@pytest.fixture(autouse=True)
def bench_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("BENCH_", "CFR_")):
            monkeypatch.delenv(k)
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def jax_weights():
    """The JAX package's weights from the seeds the port's bench uses."""
    return (jstylegan.random_params(RES, seed=0),
            jiresnet.convert_torch_state_dict(
                jiresnet.random_torch_style_state_dict(
                    "iresnet50", seed=0, realistic=True)))


def _jax_counts(jax_weights, gallery, seed, sigma):
    """bench.py's mc program (l.96-127) on the given gallery: counts and
    the noise each batch drew."""
    rng = np.random.default_rng(0)
    dirs = jnp.asarray(np.linalg.qr(
        rng.standard_normal((512, 5)))[0][:, :5].T, jnp.float32)
    embed = jmake_lat2embs("insightface", RES, dtype=jnp.float32)

    def predict_fn(params, z, p):
        w = z[None, :] + jnp.dot(p, dirs)
        embs = embed(params["gen"], params["frm"], w).astype(jnp.float32)
        return JD.argmin_dist_refined(embs, params["gallery"], "insightface")

    counts = make_counts_fn(predict_fn, N_GALLERY, jcert.L2Certificate(),
                            batch_size=BATCH, noise_dim=5, with_params=True)
    params = {"gen": jax_weights[0], "frm": jax_weights[1],
              "gallery": jnp.asarray(gallery)}
    z = jnp.asarray(rng.standard_normal(512), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), N_BATCHES)
    sigma = jnp.asarray(sigma, jnp.float32)
    noise = np.stack([np.asarray(jcert.L2Certificate().sample_noise(
        k, (BATCH, 5), sigma)) for k in keys])
    out = counts(params, z, jnp.zeros((5,), jnp.float32), sigma, keys,
                 jnp.full((N_BATCHES,), BATCH, jnp.int32))
    return np.asarray(out), noise


# The bench's gallery rows are N(0, 1), of norm ~22, while the He-scaled
# ArcFace embeddings have norms of ~4.3e6: every distance is ~|e|^2 =
# 1.8e13, whose f32 ulp (2e6) is half the gap between the nearest two rows,
# so each package's rounding picks the class. The counts are compared on
# rows of the embeddings' norm (the JAX bench's draw, rescaled), where the
# nearest row leads by 4 % at sigma 0.1 and by 1.8 % at sigma 300.
GALLERY_NORM = 4.3e6


def _scaled(rows):
    rows = np.asarray(rows, np.float64)
    return (rows / np.linalg.norm(rows, axis=1, keepdims=True)
            * GALLERY_NORM).astype(np.float32)


@pytest.mark.parametrize("seed,sigma", [(3, 0.1), (10, 300.0)])
def test_mc_counts_match_jax_with_jax_noise(jax_weights, seed, sigma):
    gallery = _scaled(jax.random.normal(jax.random.PRNGKey(123),
                                        (N_GALLERY, 512), jnp.float32))
    run, per_run = bench.make_mc_run("cpu", gallery=gallery)
    assert per_run == N_BATCHES * BATCH
    want, noise = _jax_counts(jax_weights, gallery, seed, sigma)
    got = run(seed, noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == per_run
    if sigma > 1:
        assert (got > 0).sum() > 1


def test_main_prints_bench_json(monkeypatch, capsys):
    """One warm-up and ``reps`` timed runs of n_batches x batch samples;
    one JSON line with bench.py's keys and the device."""
    sums, build = [], bench.make_mc_run

    def recording(device):
        run, per_run = build(device)

        def rec(seed, noise=None):
            out = run(seed, noise)
            sums.append((seed, int(out.sum())))
            return out

        return rec, per_run

    monkeypatch.setattr(bench, "make_mc_run", recording)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == JSON_KEYS
    assert row["metric"] == "mc_smoothing_samples_per_sec_per_chip"
    assert row["unit"] == "samples/s" and row["device"] == "cpu"
    assert row["value"] > 0
    assert row["vs_baseline"] == pytest.approx(
        row["value"] / bench.BASELINE_SAMPLES_PER_SEC, abs=0.01)
    # samples = reps x n_batches x batch, after one warm-up run
    assert sums == [(r, N_BATCHES * BATCH) for r in range(4)]


def test_ab_writes_the_pair(monkeypatch, capsys, tmp_path):
    """--ab CFR_TAIL=,bc (both sides run plain ops on the CPU): the empty
    value unsets the flag, the file holds bench.py's summary keys."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CFR_TAIL", "stale")
    seen, measure = [], bench.measure

    def recording(reps=3, device="cuda"):
        seen.append((os.environ.get("CFR_TAIL"), reps))
        return measure(reps=1, device=device)

    monkeypatch.setattr(bench, "measure", recording)
    bench.main(["--ab", "CFR_TAIL=,bc", "--device", "cpu"])
    assert seen == [(None, 3), ("bc", 3)]
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "# persisted -> bench_ab_CFR_TAIL.json"
    rows = [json.loads(line) for line in out[:2]]
    assert [r["env"] for r in rows] == [{"CFR_TAIL": None},
                                        {"CFR_TAIL": "bc"}]
    assert all(set(r) == JSON_KEYS | {"env"} for r in rows)
    saved = json.load(open(tmp_path / "bench_ab_CFR_TAIL.json"))
    summary = saved["summary"]
    assert summary == json.loads(out[2])
    assert set(summary) == {"ab_flag", "values", "samples_per_sec",
                            "ratio_vs_first", "bench_env", "timestamp",
                            "device"}
    assert summary["ab_flag"] == "CFR_TAIL"
    assert summary["values"] == [None, "bc"]
    assert summary["samples_per_sec"] == [r["value"] for r in rows]
    assert summary["ratio_vs_first"][0] == 1.0
    assert summary["bench_env"]["CFR_TAIL"] == "bc"
    assert summary["device"] == "cpu"
    assert saved["runs"] == rows
    with pytest.raises(SystemExit):
        bench.main(["--ab", "CFR_TAIL", "--device", "cpu"])


# -- BENCH_MESH_ID=2 over gloo --------------------------------------------

MESH_NOISE_SCALE = 1000.0
_RANK_MAIN = """
import functools, json, numpy, torch
torch.set_num_threads(1)
from certifyingfacerecognition_torch import bench
bench.measure = functools.partial(bench.measure, reps=1)
run, _ = bench.make_mc_run("cpu", gallery=numpy.load({gallery!r}))
noise = torch.randn((2, 2, 5), generator=torch.Generator().manual_seed(1))
out = [run(0).tolist(), run(1, noise=noise * {scale}).tolist()]
if torch.distributed.get_rank() == 0:
    print("COUNTS " + json.dumps(out))
bench.main(["--device", "cpu"])
"""


def _mesh_gallery():
    return _scaled(np.random.default_rng(7).standard_normal((2, 512)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_mesh_id_2_counts_as_one_process(monkeypatch, tmp_path):
    """Two ranks, one gallery row each (BENCH_GALLERY=2, rows rescaled as
    above), so the winners of the two classes lie on different ranks: the
    counts of the bench's own noise and of large noise (classes split, the
    nearest row 0.8 % ahead) equal one process's, and rank 0 alone prints
    the JSON line of main() (one timed run) on the drawn gallery."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", BENCH_GALLERY="2", BENCH_MESH_ID="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2")
    np.save(tmp_path / "gallery.npy", _mesh_gallery())
    code = _RANK_MAIN.format(scale=MESH_NOISE_SCALE,
                             gallery=str(tmp_path / "gallery.npy"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                raise AssertionError(f"a rank did not finish in {TIMEOUT} "
                                     f"s:\n{out[-4000:]}")
            assert p.returncode == 0, out[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    monkeypatch.setenv("BENCH_GALLERY", "2")
    run, _ = bench.make_mc_run("cpu", gallery=_mesh_gallery())
    noise = torch.randn((2, 2, 5), generator=torch.Generator().manual_seed(1))
    want = [run(0).tolist(), run(1, noise=noise * MESH_NOISE_SCALE).tolist()]
    assert want[1][0] and want[1][1]          # both ranks' rows win
    lines = outs[0].splitlines()
    got = json.loads(next(x for x in lines if x.startswith("COUNTS "))[7:])
    assert got == want
    row = json.loads([x for x in lines if x.startswith("{")][-1])
    assert set(row) == JSON_KEYS and row["value"] > 0
    assert not any(x.startswith(("{", "COUNTS"))
                   for x in outs[1].splitlines())


# -- attack mode ------------------------------------------------------------

@pytest.fixture(scope="module")
def port_models():
    return bench._models(RES, "insightface", "cpu")


def test_attack_gallery_matches_jax(monkeypatch, port_models, jax_weights):
    monkeypatch.setattr(bench, "EMBED_BATCH", 3)
    w, gallery = bench.attack_gallery(*port_models, "insightface", RES,
                                      torch.float32, N_GALLERY, "cpu")
    rng = np.random.default_rng(0)
    z = rng.standard_normal((N_GALLERY, 512)).astype(np.float32)
    z = z / np.linalg.norm(z, axis=1, keepdims=True) * np.sqrt(512)
    jw = jstylegan.mapping_apply(jax_weights[0], jnp.asarray(z))
    jemb = jax.jit(jmake_lat2embs("insightface", RES))(*jax_weights, jw)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gallery.numpy(), np.asarray(jemb), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jemb).max()))
    assert not gallery.requires_grad and not gallery.is_inference()


def _call_keywords(func_name):
    """The keyword arguments of bench.py's call of ``func_name``."""
    tree = ast.parse(open(osp.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == func_name:
            return {k.arg: ast.literal_eval(k.value) for k in node.keywords}
    raise AssertionError(f"bench.py calls no {func_name}")


def test_attack_settings_are_bench_pys():
    assert bench.PGD_KWARGS == _call_keywords("find_adversaries_pgd")
    fabt = _call_keywords("find_adversaries_autoattack")
    assert bench.FABT_KWARGS == dict(fabt, attack_type="fab-t")


@pytest.mark.parametrize("attack,metric,baseline", [
    ("pgd", "pgd_attack_ids_per_min", 20.0),
    ("fab-t", "fabt_attack_ids_per_min", 20 / 1.5)])
def test_measure_attack(monkeypatch, port_models, attack, metric, baseline):
    """One warm-up and one timed attack (reps=1) at one iteration and one
    restart (FAB-t: one target class); every success re-verifies with the
    exact predictor."""
    monkeypatch.setenv("BENCH_ATTACK", attack)
    monkeypatch.setattr(bench, "EMBED_BATCH", N_GALLERY)
    monkeypatch.setattr(bench, "_models", lambda *a: port_models)
    monkeypatch.setitem(bench.PGD_KWARGS, "iters", 1)
    monkeypatch.setitem(bench.PGD_KWARGS, "restarts", 1)
    monkeypatch.setitem(bench.FABT_KWARGS, "iters", 1)
    monkeypatch.setitem(bench.FABT_KWARGS, "restarts", 1)
    monkeypatch.setitem(bench.FABT_KWARGS, "n_target_classes", 1)
    name = {"pgd": "find_adversaries_pgd",
            "fab-t": "find_adversaries_autoattack"}[attack]
    calls, attack_fn = [], getattr(bench, name)

    def recording(dists_fn, lats, labels, gen, **kw):
        out = attack_fn(dists_fn, lats, labels, gen, **kw)
        calls.append((dists_fn.args[0], lats, labels, gen.initial_seed(),
                      kw["region"], out))
        return out

    monkeypatch.setattr(bench, name, recording)
    row = bench.measure_attack(reps=1, device="cpu")
    assert set(row) == JSON_KEYS
    assert row["metric"] == metric and row["unit"] == "ids/min"
    assert row["value"] > 0 and row["device"] == "cpu"
    assert row["vs_baseline"] == pytest.approx(row["value"] / baseline,
                                               abs=0.01)
    assert [c[3] for c in calls] == [0, 1]      # a generator per attack
    predict = make_predict_fn("insightface", RES)
    n_success = 0
    for params, lats, labels, _, region, out in calls:
        assert lats.shape == (2, 512) and labels.tolist() == [0, 1]
        deltas, success = out[0], out[1]
        w = lats + G.matmul_f32(deltas, region.dirs.t())
        preds = predict(params, w)
        assert (preds[success] != labels[success]).all()
        n_success += int(success.sum())
    # the mapping of random StyleGAN weights sends every z to one w, so the
    # identities share one embedding: identity 1 is always taken for 0
    assert n_success >= len(calls)


def test_bench_surface_matches_jax():
    """Every top-level name of bench.py (functions with their parameters,
    constants) is in the port's module."""
    def names(path):
        out = {}
        for node in ast.parse(open(path).read()).body:
            if isinstance(node, ast.FunctionDef):
                out[node.name] = {a.arg for a in node.args.args +
                                  node.args.kwonlyargs}
            elif isinstance(node, ast.Assign):
                out.update({t.id: None for t in node.targets
                            if isinstance(t, ast.Name)})
        return out

    jax_names = names(osp.join(REPO, "bench.py"))
    port = names(bench.__file__)
    assert {"BASELINE_SAMPLES_PER_SEC", "measure", "measure_attack",
            "_run_ab", "main"} <= set(jax_names)
    missing = [n for n in jax_names if n not in port]
    assert not missing, missing
    for name, params in jax_names.items():
        if params is not None:
            assert params <= port[name], (name, params - port[name])
    assert bench.BASELINE_SAMPLES_PER_SEC == 33.0
