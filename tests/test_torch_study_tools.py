"""The port's study tools (tools/adaptive_study, resolution_study,
mix_study, coverage_sweep) against the JAX package's, on the CPU:

* mix_study's stopping-rule simulator: the two packages' threshold tables
  at the JAX test's deployment configuration are equal, and for the same
  class histogram, table and np.random.default_rng(seed) the two
  _simulate_samples give equal arrays for pA in {0, 0.55, 0.75, 0.95, 1};
* the tools' loops and summary arithmetic: both packages' tools run on
  the same stand-in classifier, installed by replacing the module
  attributes each tool looks up at call time (FacePipeline, the weight
  constructors and the mapping network; the JAX package is not edited).
  The stand-in predicts for a latent z the class its table gives the
  nearest gallery row, whatever the noise, so some identities certify and
  some fail selection, whatever the random stream: the JSON lines must be
  equal in every field but the timing ones, plus the port's ``device``.
  coverage_sweep runs its own threshold classifier at p = 0 and p = 1,
  where it is noise-free too;
* the port's coverage_sweep at the deployment configuration holds the JAX
  package's coverage and savings bounds (its slow test, same 300 trials);
* one real-pipeline run of each port tool (StyleGAN 32^2, batch 4, 3
  identities, a gallery of 4; iresnet-18 in place of the iresnet-50,
  since the loops do not depend on the FRM's depth): each JSON line has
  the JAX tool's keys, guaranteed mode agrees with the fixed run, and the
  cascade's certified rows agree with the native run's;
* every tool raises without CUDA unless asked for the CPU.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import contextlib
import functools
import io
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import iresnet as jir
from certifyingfacerecognition_tpu.models import pipeline as jpipe
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.smoothing import adaptive_device as jad
from certifyingfacerecognition_tpu.smoothing.certificate import \
    L2Certificate as JL2
from certifyingfacerecognition_tpu.tools import adaptive_study as jas
from certifyingfacerecognition_tpu.tools import coverage_sweep as jcs
from certifyingfacerecognition_tpu.tools import mix_study as jms
from certifyingfacerecognition_tpu.tools import resolution_study as jrs
from certifyingfacerecognition_torch.models import iresnet as tir
from certifyingfacerecognition_torch.models import pipeline as tpipe
from certifyingfacerecognition_torch.models import stylegan as tsg
from certifyingfacerecognition_torch.smoothing import adaptive_device as tad
from certifyingfacerecognition_torch.smoothing.certificate import \
    L2Certificate as TL2
from certifyingfacerecognition_torch.tools import adaptive_study as tas
from certifyingfacerecognition_torch.tools import coverage_sweep as tcs
from certifyingfacerecognition_torch.tools import mix_study as tms
from certifyingfacerecognition_torch.tools import resolution_study as trs
from certifyingfacerecognition_torch.tools import spectral_study as tss
from certifyingfacerecognition_torch.tools import weak_scaling as tws

torch.set_num_threads(1)

# ---------------------------------------------------------------- simulator

# The JAX test's deployment headline config: N = 10k, N0 = 100,
# alpha = 1e-3, batch 128, one batch per checkpoint, slack 1.0.
N, N0, ALPHA, BS, CHUNK = 10_000, 100, 0.001, 128, 1
N_BATCHES = -(-N // BS)
VALID = np.full((N_BATCHES,), BS, np.int64)
VALID[-1] = N - (N_BATCHES - 1) * BS


def _probs(p, label=0, n_classes=10):
    out = np.full((n_classes,), (1.0 - p) / (n_classes - 1))
    out[label] = p
    return out


def test_simulator_tables_equal_jax():
    want = jad.build_thresholds("sequential", N, VALID, CHUNK, ALPHA, JL2(),
                                slack=1.0, gap_target=None)
    got = tad.build_thresholds("sequential", N, VALID, CHUNK, ALPHA, TL2(),
                               slack=1.0, gap_target=None)
    for f in ("t_emit", "t_abst", "m_k"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.alpha_early, got.alpha_final, got.exact) == \
        (want.alpha_early, want.alpha_final, want.exact)


@pytest.mark.parametrize("p", [0.0, 0.55, 0.75, 0.95, 1.0])
def test_simulate_samples_equal_jax(p):
    tab = tad.build_thresholds("sequential", N, VALID, CHUNK, ALPHA, TL2(),
                               slack=1.0, gap_target=None)
    got = tms._simulate_samples(_probs(p), 0, N0, N, tab, VALID, CHUNK,
                                sims=50, rng=np.random.default_rng(3))
    want = jms._simulate_samples(_probs(p), 0, N0, N, tab, VALID, CHUNK,
                                 sims=50, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= N0 and got.max() <= N0 + N

# ------------------------------------------------------------ stand-in runs


NATIVE = 32


def decision_table(resolution, n_rows):
    """The class predicted for each gallery row's identity: identities
    2 and 5 (mod 6) fail selection; below NATIVE also 1 and 3."""
    out = np.arange(n_rows)
    bad = [i for i in range(n_rows) if i % 6 in (2, 5)]
    if resolution < NATIVE:
        bad += [i for i in range(n_rows) if i % 6 in (1, 3)]
    out[bad] = (out[bad] + 1) % n_rows
    return out


class JaxStandin:
    """FacePipeline's interface over the stand-in classifier (JAX)."""

    def __init__(self, gen_params, frm_params, dirs, frs_method,
                 resolution, dtype, gallery=None):
        self.resolution, self.gallery = resolution, gallery

    def lat2embs(self, w, chunk=0):
        return jnp.asarray(w)

    def predict_fn_with_params(self):
        table = jnp.asarray(decision_table(self.resolution,
                                           self.gallery.shape[0]))

        def fn(gallery, z, p):
            d = jnp.sum((gallery - z[None, :]) ** 2, axis=1)
            return jnp.full((p.shape[0],), table[jnp.argmin(d)], jnp.int32)

        return fn, self.gallery


class TorchStandin:
    """FacePipeline's interface over the stand-in classifier (port)."""

    def __init__(self, gen_params, frm_params, dirs, frs_method,
                 resolution, dtype, gallery=None, device="cpu"):
        self.resolution, self.gallery = resolution, gallery
        self.device = torch.device(device)

    def lat2embs(self, w, chunk=0):
        return torch.as_tensor(w, dtype=torch.float32)

    def predict_fn_with_params(self):
        table = torch.as_tensor(decision_table(self.resolution,
                                               self.gallery.shape[0]))

        def fn(gallery, z, p):
            d = ((gallery - z[None, :]) ** 2).sum(1)
            return table[torch.argmin(d)].expand(p.shape[0])

        return fn, self.gallery


def _standin(mp, pipeline, stylegan, iresnet, cls):
    """Install the stand-in: identity mapping (w = z) and empty weights."""
    mp.setattr(pipeline, "FacePipeline", cls)
    mp.setattr(stylegan, "random_params", lambda *a, **k: {})
    mp.setattr(stylegan, "mapping_apply", lambda params, z: z)
    mp.setattr(iresnet, "random_torch_style_state_dict", lambda *a, **k: {})
    mp.setattr(iresnet, "convert_torch_state_dict", lambda *a, **k: {})


TIMING = re.compile(r"(^|_)s(_|$)|ids_per_hour|samples_per_sec|t_sample_ms"
                    r"|^overhead_")


def _strip(line):
    """A JSON line without its timing fields (recursively)."""
    if isinstance(line, dict):
        return {k: _strip(v) for k, v in line.items() if not TIMING.search(k)}
    return line


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


AS_ENV = dict(AS_IDS="6", AS_GALLERY="6", AS_N="256", AS_N0="32",
              AS_BATCH="32", AS_CHUNK="2", AS_SIGMA="1.0",
              AS_RESOLUTION=str(NATIVE))
RS_ENV = dict(RS_IDS="6", RS_GALLERY="6", RS_N="256", RS_N0="32",
              RS_BATCH="32", RS_RESOLUTIONS=f"{NATIVE},16")
MS_ENV = dict(MS_IDS="6", MS_GALLERY="8", MS_N="256", MS_N0="32",
              MS_BATCH="32", MS_GROUP="2", MS_OVERHEAD_IDS="2",
              MS_SIMS="20", MS_RESOLUTION=str(NATIVE))
CS_ENV = dict(CS_PGRID="0,1", CS_TRIALS="3", CS_N="256", CS_N0="32",
              CS_BATCH="32", CS_CHUNK="2")
CASES = {
    "adaptive_host": (jas, tas, dict(AS_ENV, AS_GALLERY_PAD="16")),
    "adaptive_device_grouped": (jas, tas, dict(
        AS_ENV, AS_MODES="fixed,guaranteed,sequential", AS_ENGINE="device",
        AS_GROUP="2", AS_SLACK="1.0")),
    "adaptive_ab": (jas, tas, dict(AS_ENV, AS_MODES="fixed,sequential",
                                   AS_AB="CFR_TAIL=,bc")),
    "resolution": (jrs, trs, RS_ENV),
    "resolution_gamma": (jrs, trs, dict(RS_ENV, RS_SPECTRAL_GAMMA="-0.5")),
    "mix": (jms, tms, MS_ENV),
    "mix_probe": (jms, tms, dict(MS_ENV, MS_PROBE="64")),
    "coverage": (jcs, tcs, CS_ENV),
}


@functools.lru_cache(maxsize=None)
def _jax_lines(case):
    """The JAX tool's JSON lines of a case, on the stand-in."""
    jmod, _, env = CASES[case]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setenv("CFR_TAIL", "")      # AS_AB sets it: restored on exit
        _standin(mp, jpipe, jsg, jir, JaxStandin)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jmod.main()
    return [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith("{")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_lines_equal_jax(case, monkeypatch, capsys):
    _, tmod, env = CASES[case]
    want = _jax_lines(case)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CFR_TAIL", "")
    _standin(monkeypatch, tpipe, tsg, tir, TorchStandin)
    tmod.main(["--device", "cpu"])
    got = _lines(capsys)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.pop("device") == "cpu"
        assert sorted(g) == sorted(w)
        assert _strip(g) == _strip(w)
    if case == "adaptive_host":
        # the stand-in makes every decision settled: agreement is exact
        assert [x["decision_agreement_vs_fixed"] for x in got[1:]] == [1, 1]
        assert [x["certified_correct"] for x in got] == [4, 4, 4]
        assert got[0]["gallery"] == 16
    if case == "resolution":
        assert got[3]["cascade"]["lost_certifications"] == 2


# ------------------------------------------------------ coverage, deployment


def test_port_sequential_coverage_at_deployment_config():
    """The bounds of the JAX package's slow deployment-config test, on the
    port's certify_adaptive (the same 300 trials: the port runs them in a
    few seconds on the CPU)."""
    kw = dict(trials=300, n=10_000, n0=100, alpha=0.001, batch=128, chunk=8,
              slack=0.1, mode="sequential", device="cpu")
    clear = tcs.sweep_point(0.999, **kw)
    assert clear["certified"] == 300 and clear["violations"] == 0
    assert clear["mean_samples"] < 0.6 * 10_100
    boundary = tcs.sweep_point(0.55, **kw)
    assert boundary["violations"] <= 2, boundary
    assert boundary["mean_samples"] > 0.8 * 10_100

# ------------------------------------------------------- real pipeline (CPU)


@functools.lru_cache(maxsize=None)
def _frm18(random_sd=tir.random_torch_style_state_dict):
    return random_sd("iresnet18", seed=0, realistic=True)


def _real(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("CFR_TAIL", "bc")
    monkeypatch.setattr(tir, "random_torch_style_state_dict",
                        lambda *a, **k: _frm18())
    convert = tir.convert_torch_state_dict
    monkeypatch.setattr(tir, "convert_torch_state_dict",
                        lambda sd, arch="iresnet50", device="cuda":
                        convert(sd, "iresnet18", device))


def _keys(line):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in line.items() if k != "device"}


REAL = {
    "adaptive": (tas, dict(AS_IDS="3", AS_GALLERY="4", AS_N="4", AS_N0="4",
                           AS_BATCH="4", AS_CHUNK="1", AS_ALPHA="0.1",
                           AS_SIGMA="0.05", AS_RESOLUTION="32"),
                 "adaptive_host"),
    "resolution": (trs, dict(RS_IDS="3", RS_GALLERY="4", RS_N="4",
                             RS_N0="4", RS_BATCH="4", RS_ALPHA="0.1",
                             RS_SIGMA="0.05", RS_RESOLUTIONS="32,16"),
                   "resolution"),
    "mix": (tms, dict(MS_IDS="3", MS_GALLERY="4", MS_N="4", MS_N0="4",
                      MS_BATCH="4", MS_GROUP="1", MS_OVERHEAD_IDS="1",
                      MS_ALPHA="0.1", MS_SIGMA="0.05", MS_SIMS="10",
                      MS_RESOLUTION="32"), "mix"),
}


@pytest.mark.parametrize("tool", sorted(REAL))
def test_real_pipeline_run(tool, monkeypatch, capsys):
    tmod, env, case = REAL[tool]
    _real(monkeypatch, env)
    tmod.main(["--device", "cpu"])
    got = _lines(capsys)
    want = _jax_lines(case)
    if tool == "adaptive":
        want = want[:3]
    assert [_keys(g) for g in got] == [_keys(w) for w in want]
    assert all(g["device"] == "cpu" for g in got)
    if tool == "adaptive":
        assert [g["decision_agreement_vs_fixed"] for g in got[1:2]] == [1.0]
        assert got[0]["certified_correct"] > 0
    if tool == "resolution":
        assert got[-1]["cascade"]["certified_row_agreement"] == 1.0
    if tool == "mix":
        assert 0.0 <= got[0]["p_hat_mean"] <= 1.0


def test_spectral_main_lines(monkeypatch, capsys):
    monkeypatch.setenv("SS_GAMMAS", "0,-1")
    monkeypatch.setenv("SS_RESOLUTION", "32")
    monkeypatch.setenv("SS_IMAGES", "2")
    tss.main(["--device", "cpu"])
    got = _lines(capsys)
    assert [sorted(x) for x in got] == [
        ["device", "gamma", "psd_slope", "resolution", "target"]] * 2 + [
        ["chosen_gamma", "chosen_slope", "device"]]
    assert all(np.isfinite(x["psd_slope"]) for x in got[:2])


@pytest.mark.parametrize("main", [tas.main, trs.main, tms.main, tcs.main,
                                  tss.main, tws.main],
                         ids=["adaptive_study", "resolution_study",
                              "mix_study", "coverage_sweep",
                              "spectral_study", "weak_scaling"])
def test_tool_needs_cuda_unless_cpu(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
