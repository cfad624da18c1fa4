"""The rest of the port's public surface against the JAX package's, f32 on
the CPU at 32^2 (random StyleGAN weights and He-scaled ArcFace iresnet-18
weights carried across with params_from_jax; the default random ArcFace
weights drive every embedding to NaN):

* stylegan.synthesize_from_z: images to 1e-4 (rtol and atol, as
  tests/test_torch_stylegan.py holds synthesize_from_w);
* distances.euclidean_exact: to 1e-5 (rtol and atol) against the JAX
  function and against torch.cdist;
* FacePipeline.logits and probs to 1e-4 relative, predict and
  predict_fn exactly, the gradient of logits with respect to p (jax.grad
  of the JAX FacePipeline.logits) to 1e-2 of its largest value;
* make_dists_fn: remat=False and remat=True give the same distances and
  the same gradient with respect to w exactly, and both equal the JAX
  make_dists_fn(remat=False)'s: distances to 1e-4 relative, the gradient
  to 1e-2 of its largest value.

  The gradients' bound is f32's own floor for them, not a port error:
  through the mapping, the synthesis and 18 ArcFace layers a
  pre-activation within f32 rounding of 0 takes the other lrelu / prelu
  branch in one framework (tests/test_torch_attack_cli.py). Measured at
  this test's sample, against a float64 run of the port: the port's f32
  gradient of logits is 1.9e-3 of its largest value away, the JAX
  package's 7.5e-3, and the two 6.9e-3 apart, while the logits agree to
  4e-8. A lost or misrouted gradient term is off by order 1.
* save_chunk_results(also_torch=True): the .pth's keys, shapes and dtypes
  equal those of the JAX function's .pth, and load_chunk_data reads the
  .npz's values back from it;
* setup_logger(logfile_name=...): the same files and refusals as the JAX
  function; the five constants; cli.opts.parse_args field by field
  against the JAX parse_args; L2Certificate.compute_proxy_gap and
  compute_radius_estimate to 1e-5;
* run_standard_evaluation_individual on the toy problem of
  tests/test_torch_autoattack.py, with its draws injected:
  each result re-verifies (the JAX test's check) and equals
  run_standard_evaluation with that one attack on the same draws exactly;
  its log lines, the clean-accuracy-0 line and the refusal of an unknown
  version;
* the public surface: every public top-level name, class method and
  function parameter of each JAX module is in the same-named port module,
  apart from the ones ROADMAP.md lists as deliberately not ported.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import ast
import glob
import logging
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu import constants as jconst
from certifyingfacerecognition_tpu.cli import opts as jopts
from certifyingfacerecognition_tpu.eval import artifacts as jart
from certifyingfacerecognition_tpu.eval import chunk_runner as jcr
from certifyingfacerecognition_tpu.models import iresnet as jir
from certifyingfacerecognition_tpu.models import pipeline as jpl
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.ops import distances as jd
from certifyingfacerecognition_tpu.ops import geometry as jg
from certifyingfacerecognition_tpu.smoothing import certificate as jcert
from certifyingfacerecognition_tpu.utils import logger as jlog
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch import constants as tconst
from certifyingfacerecognition_torch.attacks import autoattack as taa
from certifyingfacerecognition_torch.attacks import square as tsq
from certifyingfacerecognition_torch.cli import opts as topts
from certifyingfacerecognition_torch.eval import artifacts as tart
from certifyingfacerecognition_torch.eval import chunk_runner as tcr
from certifyingfacerecognition_torch.models import pipeline as tpl
from certifyingfacerecognition_torch.models import stylegan as tsg
from certifyingfacerecognition_torch.ops import distances as td
from certifyingfacerecognition_torch.ops import geometry as G
from certifyingfacerecognition_torch.smoothing import certificate as tcert
from certifyingfacerecognition_torch.utils import logger as tlog
from certifyingfacerecognition_torch.utils import weights as tw
from test_torch_autoattack import PRESET_KW, _toy

RES = 32
torch.set_num_threads(1)


B_FWD, B_GRAD = 4, 1


@pytest.fixture(scope="module")
def case():
    """The two packages' weights at RES (the port's carried across with
    params_from_jax), a gallery of four identities (the port's
    embeddings), a latent between identities 0 and 1, perturbations p of
    B_FWD samples (the first B_GRAD take gradients), and the JAX
    results, all from one jitted function with the weights as arguments
    (one compile)."""
    jgen = jsg.random_params(RES, seed=0)
    jfrm = jir.convert_torch_state_dict(
        jir.random_torch_style_state_dict("iresnet18", seed=0,
                                          realistic=True), "iresnet18")
    tgen = tw.params_from_jax(jw.flatten_params(jgen), device="cpu")
    tfrm = tw.params_from_jax(jw.flatten_params(jfrm), device="cpu")
    dirs = np.asarray(jg.get_all_matrices().dirs).T
    rng = np.random.default_rng(0)
    ws = rng.standard_normal((4, 512)).astype(np.float32)
    tpipe = tpl.FacePipeline(tgen, tfrm, dirs=torch.tensor(dirs),
                             resolution=RES, device="cpu")
    # an inference tensor, as lat2embs makes it: logits still take
    # gradients against it
    gallery = tpipe.lat2embs(ws)
    tpipe.gallery = gallery
    z = (ws[0] + ws[1]) / 2
    p = (20.0 * rng.standard_normal((B_FWD, dirs.shape[0]))).astype(
        np.float32)
    zs = rng.standard_normal((B_FWD, 512)).astype(np.float32)
    cot = rng.standard_normal((B_GRAD, 4)).astype(np.float32)
    jdists = jcr.make_dists_fn("insightface", RES, remat=False)

    def ref(params, z, p, zs):
        pipe = jpl.FacePipeline(params["gen"], params["frm"],
                                dirs=params["dirs"], resolution=RES,
                                gallery=params["gallery"])
        pg = p[:B_GRAD]
        d, vjp = jax.vjp(lambda w: jdists(params, w),
                         pipe.perturb_latents(z, pg))
        return {"perturbed": pipe.perturb_latents(z, p),
                "logits": pipe.logits(z, p), "probs": pipe.probs(z, p),
                "predict": pipe.predict(z, p),
                "grad_p": jax.grad(lambda pg: jnp.sum(
                    pipe.logits(z, pg) * cot))(pg),
                "dists": d, "grad_w": vjp(-jnp.asarray(cot))[0],
                "image": jsg.synthesize_from_z(params["gen"], zs,
                                               resolution=RES)}

    want = jax.jit(ref)({"gen": jgen, "frm": jfrm, "dirs": jnp.asarray(dirs),
                         "gallery": jnp.asarray(gallery.numpy())},
                        jnp.asarray(z), jnp.asarray(p), jnp.asarray(zs))
    return {"pipe": tpipe, "z": z, "p": p, "zs": zs, "cot": cot,
            "want": {k: np.asarray(v) for k, v in want.items()}}


def _rel_max(got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# -- small functions --------------------------------------------------------

@pytest.mark.parametrize("name", ["LAT_SPACE", "DATASET", "GAN_NAME",
                                  "IMAGE_EXT", "STYLEGAN_RANDOMIZE_NOISE"])
def test_constants_match_jax(name):
    assert getattr(tconst, name) == getattr(jconst, name)


def test_euclidean_exact_matches_jax_and_cdist():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 512)).astype(np.float32)
    y = rng.standard_normal((7, 512)).astype(np.float32)
    got = td.euclidean_exact(torch.tensor(x), torch.tensor(y)).numpy()
    assert got.shape == (5, 7)
    np.testing.assert_allclose(
        got, np.asarray(jd.euclidean_exact(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, torch.cdist(torch.tensor(x), torch.tensor(y),
                         compute_mode="donot_use_mm_for_euclid_dist").numpy(),
        rtol=1e-5, atol=1e-5)


def test_synthesize_from_z_matches_jax(case, monkeypatch):
    monkeypatch.delenv("CFR_TAIL", raising=False)
    got = tsg.synthesize_from_z(case["pipe"].gen_params,
                                torch.tensor(case["zs"]), resolution=RES)
    assert got.shape == (B_FWD, 3, RES, RES)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               case["want"]["image"], rtol=1e-4, atol=1e-4)


def test_certificate_proxy_gap_and_radius_match_jax():
    probs = np.array([[0.9, 0.1], [0.5, 0.5], [1.0, 0.0], [0.3, 0.6]],
                     np.float32)
    jc, tc = jcert.L2Certificate(), tcert.L2Certificate()
    for got, want in (
            (tc.compute_proxy_gap(torch.tensor(probs)),
             jc.compute_proxy_gap(jnp.asarray(probs))),
            (tc.compute_radius_estimate(torch.tensor(probs), 0.5),
             jc.compute_radius_estimate(jnp.asarray(probs), 0.5))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mod", [jlog, tlog], ids=["jax", "torch"])
def test_setup_logger_logfile_name(mod, tmp_path):
    """Both packages: the log goes to work_dir/logfile_name; a second
    setup of the name raises SystemExit unless allow_existing, which
    returns the logger as it is; an existing log file raises SystemExit
    unless allow_existing."""
    name = f"api_remainder_{mod.__name__}"
    logger = mod.setup_logger(str(tmp_path), logfile_name="run.log",
                              logger_name=name)
    try:
        logger.info("hello")
        assert open(tmp_path / "run.log").read().rstrip().endswith("hello")
        assert not (tmp_path / "log.txt").exists()
        with pytest.raises(SystemExit, match="already been set up"):
            mod.setup_logger(str(tmp_path), logfile_name="other.log",
                             logger_name=name)
        assert mod.setup_logger(str(tmp_path), logfile_name="other.log",
                                logger_name=name,
                                allow_existing=True) is logger
        assert not (tmp_path / "other.log").exists()
    finally:
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
    with pytest.raises(SystemExit, match="already exists"):
        mod.setup_logger(str(tmp_path), logfile_name="run.log",
                         logger_name=name + "_2")
    logging.getLogger(name + "_2").handlers.clear()


def test_parse_args_matches_jax(tmp_path, monkeypatch):
    """Every field of the JAX parse_args's namespace, LOGGER and the port's
    own device and model_name (the generator, default stylegan_ffhq, the
    JAX CLI's only one) aside; the two runs write under different
    --output-dirs (the logger name follows it), so their paths are
    compared with the name swapped."""
    monkeypatch.chdir(tmp_path)
    argv = ["--attack-type", "apgd-t", "--num-chunk", "1", "--chunks", "4",
            "--iters", "7", "--mesh", "--dtype", "bf16"]
    want = vars(jopts.parse_args(["--output-dir", "api_rem_jax"] + argv))
    got = vars(topts.parse_args(["--output-dir", "api_rem_torch"] + argv))
    try:
        assert set(got) - {"device", "model_name"} == set(want)
        assert got["model_name"] == "stylegan_ffhq"
        for key, value in want.items():
            if key == "LOGGER":
                continue
            if isinstance(value, str):
                value = value.replace("api_rem_jax", "api_rem_torch")
            assert got[key] == value, key
        assert osp.isdir(got["figs_dir"]) and osp.isfile(got["info_log"])
        assert osp.isfile(osp.join(got["output_dir"], "chunk_1", "log.txt"))
    finally:
        for ns in (want, got):
            tlog.close_logger(ns["LOGGER"])


def test_save_chunk_results_also_torch_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    deltas = rng.standard_normal((6, 5)).astype(np.float32)
    successes = np.array([True, False, True, True, False, False])
    mags = rng.random(6).astype(np.float32)
    files = {}
    for tag, mod in (("jax", jart), ("torch", tart)):
        d = tmp_path / tag
        (d / "results").mkdir(parents=True)
        (d / "logs").mkdir()
        _, data_file = mod.save_chunk_results(
            {"successes": 3, "instances": 6, "avg_mags": 0.5}, deltas,
            successes, mags, 1, 4, str(d / "results"), str(d / "logs"),
            also_torch=True)
        files[tag] = data_file
        assert data_file == str(d / "results" / "results_chunk1of4.npz")
    pth = {t: torch.load(f[:-4] + ".pth") for t, f in files.items()}
    assert list(pth["torch"]) == list(pth["jax"])
    for k, v in pth["jax"].items():
        assert pth["torch"][k].shape == v.shape and \
            pth["torch"][k].dtype == v.dtype, k
        assert torch.equal(pth["torch"][k], v), k
    npz = tart.load_chunk_data(files["torch"])
    for k, v in tart.load_chunk_data(files["torch"][:-4] + ".pth").items():
        np.testing.assert_array_equal(v.reshape(npz[k].shape), npz[k])


# -- the classifier surface -------------------------------------------------

def test_pipeline_classifier_matches_jax(case, monkeypatch):
    monkeypatch.delenv("CFR_TAIL", raising=False)
    pipe, want = case["pipe"], case["want"]
    z, p = torch.tensor(case["z"]), torch.tensor(case["p"])
    np.testing.assert_array_equal(pipe.perturb_latents(z, p).numpy(),
                                  want["perturbed"])
    logits = pipe.logits(z, p)
    assert logits.shape == (B_FWD, 4)
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               rtol=1e-4)
    np.testing.assert_allclose(pipe.probs(z, p).detach().numpy(),
                               want["probs"], rtol=1e-4)
    pred = pipe.predict(z, p).numpy()
    np.testing.assert_array_equal(pred, want["predict"])
    np.testing.assert_array_equal(pred, np.argmax(want["logits"], 1))
    assert len(set(pred.tolist())) > 1
    np.testing.assert_array_equal(pipe.predict_fn()(z, p).numpy(), pred)


def test_pipeline_logits_gradient_matches_jax(case, monkeypatch):
    monkeypatch.delenv("CFR_TAIL", raising=False)
    pg = torch.tensor(case["p"][:B_GRAD], requires_grad=True)
    logits = case["pipe"].logits(torch.tensor(case["z"]), pg)
    (got,) = torch.autograd.grad(
        (logits * torch.tensor(case["cot"])).sum(), pg)
    assert _rel_max(got.numpy(), case["want"]["grad_p"]) <= 1e-2


def test_dists_fn_remat_matches_jax(case, monkeypatch):
    """remat=False and remat=True against each other exactly, and against
    the JAX make_dists_fn(remat=False) at the latents of logits' gradient
    test (the cotangent negated: logits = -distances)."""
    monkeypatch.delenv("CFR_TAIL", raising=False)
    pipe, want = case["pipe"], case["want"]
    # make_dists_fn's caller gives a gallery that autograd can save
    params = {"gen": pipe.gen_params, "frm": pipe.frm_params,
              "gallery": pipe.gallery.clone()}
    w = pipe.perturb_latents(torch.tensor(case["z"]),
                             torch.tensor(case["p"][:B_GRAD]))
    out = {}
    for remat in (False, True):
        wt = w.clone().requires_grad_()
        d = tcr.make_dists_fn("insightface", RES, remat=remat)(params, wt)
        (g,) = torch.autograd.grad((d * -torch.tensor(case["cot"])).sum(),
                                   wt)
        out[remat] = (d.detach(), g)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    np.testing.assert_allclose(out[False][0].numpy(), want["dists"],
                               rtol=1e-4)
    assert _rel_max(out[False][1].numpy(), want["grad_w"]) <= 1e-2


# -- run_standard_evaluation_individual -------------------------------------

class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


_GEN = torch.Generator().manual_seed(0)      # unused: every draw injected


def test_run_standard_evaluation_individual():
    """Each attack's result re-verifies (the JAX test's check) and equals
    run_standard_evaluation with that one attack on the same draws."""
    _, tlogits, labels, _, rt = _toy(n_gallery=4)
    names = ("apgd-ce", "square")
    gen, ell, b = torch.Generator().manual_seed(3), rt.red_ellipse, len(labels)
    draws = {
        "apgd-ce": G.init_deltas(gen, b, ell)[None],
        "square": (G.init_deltas(gen, b, ell)[None],
                   *(t[None] for t in tsq.draw_square(
                       gen, b, ell.dim, PRESET_KW["square_queries"])))}
    lines = _Lines()
    got = taa.run_standard_evaluation_individual(
        tlogits, torch.tensor(labels), _GEN, rt, attacks_to_run=names,
        logger=lines, draws=draws, **PRESET_KW)
    assert list(got) == list(names)
    assert any(res.success.any() for res in got.values())
    for name, res in got.items():
        preds = tlogits(res.deltas).argmax(1).numpy()
        np.testing.assert_array_equal(preds != labels, res.success.numpy())
        one = taa.run_standard_evaluation(
            tlogits, torch.tensor(labels), _GEN, rt, attacks_to_run=(name,),
            draws=draws, **PRESET_KW)
        assert res.robust_accuracy == one.robust_accuracy
        for a, b in zip(res[:4], one[:4]):
            assert torch.equal(a, b)
    assert [line.split(" \t ")[:2] for line in lines.lines] == [
        [f"robust accuracy by {n.upper()}",
         f"{got[n].robust_accuracy[n]:.2%}"] for n in names]


def test_run_standard_evaluation_individual_clean_zero_and_refusal():
    _, tlogits, labels, _, rt = _toy(n_gallery=4)
    lines = _Lines()
    # every label wrong: clean accuracy 0, so no attack runs
    wrong = torch.full((len(labels),), 3)
    out = taa.run_standard_evaluation_individual(
        tlogits, wrong, _GEN, rt, attacks_to_run=("square",), logger=lines,
        **PRESET_KW)
    assert out["square"].robust_accuracy == {"clean": 0.0}
    assert out["square"].success.all()
    assert lines.lines[0].startswith("robust accuracy by SQUARE \t 0.00% \t")
    with pytest.raises(ValueError, match="unknown AutoAttack version"):
        taa.run_standard_evaluation_individual(tlogits, wrong, _GEN, rt,
                                               version="bogus")


# -- the public surface -----------------------------------------------------

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_PKG = osp.join(ROOT, "certifyingfacerecognition_tpu")
PORT_PKG = osp.join(ROOT, "certifyingfacerecognition_torch")
# JAX idioms the port replaces with its own (ROADMAP.md, "Deliberately not
# ported"): PRNG keys are torch.Generators, precision= is a dtype choice
JAX_ONLY_PARAMS = {"key", "keys", "precision"}
NOT_PORTED = {
    "attacks/checks.py": {"check_retracing(jitted_fn)"},
    "models/nn.py": {"conv2d_frozen", "conv2d_transpose", "dense",
                     "precision_for", "conv2d(kernel)",
                     "conv2d(feature_group_count)", "blur_3x3(frozen)"},
    "ops/geometry.py": {"Ellipsoid.tree_flatten", "Ellipsoid.tree_unflatten"},
    "ops/synthesis_tail_bc.py": {"GROUP"},
    "parallel/gallery.py": {"sharded_argmin_dist",
                            "make_sharded_gallery_predict_fn(dirs)",
                            "make_sharded_gallery_predict_fn(axis_name)"},
    "parallel/mesh.py": {"ID_AXIS", "MC_AXIS", "get_mesh", "get_2d_mesh",
                         "get_pod_mesh", "replicated", "shard_leading"},
    "smoothing/adaptive_device.py": {"make_adaptive_run_fn",
                                     "make_adaptive_run_many_fn"},
    "smoothing/certificate.py": {"Certificate"},
    "smoothing/smooth.py": {"make_counts_fn", "Smooth.__init__(param_specs)"},
    "tools/tail_kernel_bench.py": {"HBM_GBPS"},
    "tools/weak_scaling.py": {"collective_inventory"},
    "utils/profiling.py": {"annotate", "PhaseTimer"},
}
JAX_MODULES = sorted(osp.relpath(f, JAX_PKG) for f in glob.glob(
    osp.join(JAX_PKG, "**", "*.py"), recursive=True))


def _surface(path, imports=False):
    """{top-level name: None | [params] | {method: [params]}}; with
    ``imports``, imported names too."""
    def params(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                + [a.vararg, a.kwarg] if x is not None]

    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = {m.name: params(m) for m in node.body
                              if isinstance(m, ast.FunctionDef)}
        elif isinstance(node, ast.Assign):
            out.update({t.id: None for t in node.targets
                        if isinstance(t, ast.Name)})
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out[node.target.id] = None
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update({(a.asname or a.name).split(".")[0]: None
                        for a in node.names})
    return out


def _missing(jax_items, port_items, prefix=""):
    miss = set()
    for name, item in jax_items.items():
        public = not name.startswith("_") or name == "__init__"
        if not public:
            continue
        if name not in port_items:
            miss.add(prefix + name)
        elif isinstance(item, dict):
            miss |= _missing(item, port_items[name] or {}, f"{name}.")
        elif isinstance(item, list) and port_items[name] is not None:
            # (an imported port name has no parameters to read)
            miss |= {f"{prefix}{name}({p})" for p in item
                     if p not in port_items[name] and not p.startswith("_")
                     and p not in JAX_ONLY_PARAMS}
    return miss


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_surface_matches_jax(module):
    port = osp.join(PORT_PKG, module)
    assert osp.isfile(port), f"no port module {module}"
    missing = _missing(_surface(osp.join(JAX_PKG, module)), _surface(port, imports=True))
    assert missing == NOT_PORTED.get(module, set())
