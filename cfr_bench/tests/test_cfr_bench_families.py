"""Model families found by name: the shared modules name no network, a
toy generator family added as files alone runs a certify and an attack
cell end to end, the four cells read as they did before the families
were split out, and an unknown family is refused at set-up."""

import ast
import copy
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest_helpers as H
from cfr_bench import families, flops, harness, inputs, program

SHARED = ["program.py", "inputs.py", "reference/pipeline.py", "flops.py",
          "drivers/certify.py", "drivers/attack.py"]
NETWORKS = ("stylegan", "iresnet", "facenet")
PORT = "certifyingfacerecognition_torch"
GEN_API = ("LATENT_DIM", "BOUNDARIES", "widths", "state_dict_specs",
           "synthesize", "latents", "to_program", "region", "pipeline",
           "dists_fn", "stages")
FRM_API = ("FRS", "INPUT", "EMBEDDING_DIM", "widths", "state_dict_specs",
           "embed", "to_program")
FAMILY_FILES = sorted(families.DIRS["generator"].glob("*.py")) + \
    sorted(families.DIRS["frm"].glob("*.py"))


def _imported(path: Path, nodes):
    """Dotted names of what ``nodes`` import (relative imports resolved
    from the file's package under cfr_bench)."""
    pkg = path.parent.relative_to(harness.CHECKOUT).parts
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = list(pkg[:len(pkg) - node.level + 1]) if node.level \
                else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


@pytest.mark.parametrize("name", SHARED)
def test_shared_modules_name_no_network(name):
    path = harness.HERE / name
    tree = ast.parse(path.read_text())
    for mod in _imported(path, ast.walk(tree)):
        assert mod.split(".")[-1] not in NETWORKS, (name, mod)
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not used & set(NETWORKS), name


@pytest.mark.parametrize("path", FAMILY_FILES,
                         ids=[p.name for p in FAMILY_FILES])
def test_family_files_import_the_program_only_inside_functions(path):
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any(m.split(".")[0] == PORT for m in _imported(path, top))


@pytest.mark.parametrize("entry", H.bench()["configs"],
                         ids=[c["name"] for c in H.bench()["configs"]])
def test_configs_name_families_that_provide_the_interface(entry):
    config = harness.load_json(harness.CHECKOUT / entry["file"])
    gen, frm = families.of(config)
    assert all(hasattr(gen, a) for a in GEN_API)
    assert all(hasattr(frm, a) for a in FRM_API)
    assert len(gen.BOUNDARIES) == 5
    assert all((program.BOUNDARIES / f).is_file() for f in gen.BOUNDARIES)
    assert config["frs"] in frm.FRS


@pytest.mark.parametrize("key,name,listed",
                         [("generator", "pggan_celebahq", "stylegan_ffhq"),
                          ("frm_arch", "iresnet100",
                           "inception_resnet_v1, iresnet50")])
def test_unknown_family_is_refused_before_weights(key, name, listed,
                                                  monkeypatch):
    drawn = []
    monkeypatch.setattr(inputs, "state_dict",
                        lambda *a, **k: drawn.append(a))
    ctx, _ = H.tiny_cell("sg1024-r50.certify")
    ctx.config = dict(ctx.config, **{key: name})
    with pytest.raises(ValueError, match=listed) as err:
        program.build(ctx)
    assert repr(name) in str(err.value) and not drawn


# -- the four cells as the parent commit read them ---------------------------

# ``run_tiny(cell)`` (32^2, float32, the tiny traffic, seed 2^31 + 7) in a
# fresh process with one thread, as the commit before the families were
# split out read it on an x86-64 CPU. The same draws, calls and
# comparisons give the same numbers, counts exactly; a float may differ in
# its last bit, as the CPU's vectorised sums depend on where a process's
# buffers happen to lie (the same code reads delta_excess, a sum of
# about 1 less 1, as 6.849042555323592e-08 or 6.849042577528053e-08 in two
# processes), so floats are held to float64's round-off: 1e-12 of the
# reading, or 1e-15 for a difference from 1.
PINNED = {
    "sg1024-r50.certify": {"noise_z": 1.7121988674507922,
                           "emb_err": 3.3906251502120506e-06,
                           "pair_err": 3.132071058593372e-05,
                           "head_miss": 0, "cert_miss": 0},
    "sg1024-r50.pgd": {"emb_err": 3.177953518037536e-06,
                       "dist_err": 1.9770946950688854e-06,
                       "delta_excess": 6.849042555323592e-08,
                       "step_angle": 9.074529150332467e-07,
                       "false_success": 0},
    "sg1024-facenet.certify": {"noise_z": 1.7121988674507922,
                               "emb_err": 1.115200735675245e-06,
                               "pair_err": 3.837871660114018e-05,
                               "head_miss": 0, "cert_miss": 0},
    "sg1024-r50.fabt": {"emb_err": 3.177953518037536e-06,
                        "dist_err": 6.679286461990028e-07,
                        "false_success": 0},
}
READ_CHECKS = """
import json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
import conftest_helpers as H
res = H.run_tiny({cell!r})
print(json.dumps({{k: c["value"] for k, c in res["checks"].items()}}))
"""


@pytest.mark.parametrize("cell", list(PINNED))
def test_cells_read_as_before(cell):
    # a process of its own: the thread pools, and so the order of the
    # CPU's sums, are the ones the readings were pinned with
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(harness.CHECKOUT))
    code = READ_CHECKS.format(tests=str(Path(__file__).parent), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=harness.CHECKOUT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got == pytest.approx(PINNED[cell], rel=1e-12, abs=1e-15)
    assert all(got[k] == v for k, v in PINNED[cell].items()
               if isinstance(v, int))


# FLOPs a sample at 1024^2 that certify.mfu and attack.mfu divide by, as
# the commit before read them (gallery 10k for certify, 1k for the attacks)
@pytest.mark.parametrize("config,rows,want", [
    ("stylegan-ffhq1024-arcface-r50", 10000, 77099286528.0),
    ("stylegan-ffhq1024-arcface-r50", 1000, 77090070528.0),
    ("stylegan-ffhq1024-facenet-vggface2", 10000, 67315949248.0)])
def test_forward_flops_as_before(config, rows, want):
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    assert flops.forward_flops(cfg, rows) == want


# -- a generator family unlike StyleGAN, added as files alone ----------------

TOY = '''"""A toy generator family: z on the sqrt(512) sphere -> pixel norm ->
dense to 32 x 4 x 4 -> nearest up to R -> conv 3x3 -> leaky ReLU -> pixel
norm -> conv 1x1 to RGB -> tanh -> [0, 1]; directions in Z. Its program
half runs the same plain code through the program's FRM and head."""

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cfr_bench import inputs
from cfr_bench.reference.pipeline import ATTRS

HERE = Path(__file__).resolve().parent
LATENT_DIM = 512
CHANNELS = 32
BOUNDARIES = tuple(str(HERE / f"toy_z_{a}_boundary.npy") for a, _ in ATTRS)


def widths(resolution):
    return {"toy_channels": CHANNELS, "toy_convs": 2, "z_dim": LATENT_DIM}


def state_dict_specs(resolution):
    c = CHANNELS
    return [("dense.weight", (16 * c, LATENT_DIM),
             1.0 / math.sqrt(LATENT_DIM), 0.0),
            ("dense.bias", (16 * c,), 0.1, 0.0),
            ("conv.weight", (c, c, 3, 3), math.sqrt(2.0 / (9 * c)), 0.0),
            ("rgb.weight", (3, c, 1, 1), 1.0 / math.sqrt(c), 0.0),
            ("rgb.bias", (3,), 0.1, 0.0)]


def _pixel_norm(x):
    return x * torch.rsqrt((x * x).mean(1, keepdim=True) + 1e-8)


def synthesize(sd, z, resolution, prec):
    x = prec.linear(_pixel_norm(z), sd["dense.weight"], sd["dense.bias"])
    x = _pixel_norm(F.leaky_relu(x.view(-1, CHANNELS, 4, 4), 0.2))
    x = F.interpolate(x, size=(resolution, resolution), mode="nearest")
    x = prec.conv2d(x, sd["conv.weight"], padding=1)
    x = _pixel_norm(F.leaky_relu(x, 0.2))
    img = prec.conv2d(x, sd["rgb.weight"]) + sd["rgb.bias"].view(1, 3, 1, 1)
    return (torch.tanh(img) + 1.0) / 2.0


def latents(n, seed, device):
    z = torch.randn((n, LATENT_DIM), device=device,
                    generator=inputs.generator(seed, inputs.LATENTS, device))
    return z * (math.sqrt(LATENT_DIM) / z.norm(dim=1, keepdim=True))


def to_program(sd, resolution, device):
    return {k: torch.as_tensor(v, device=device) for k, v in sd.items()}


def region(device, boundaries_dir):
    from certifyingfacerecognition_torch.ops import geometry as G

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    dirs = np.concatenate([np.load(f) for f in BOUNDARIES]).T
    ell = G.get_ellipse_mat(dirs)
    red = np.diagonal(G.get_ellipse_mat(np.diag([m for _, m in ATTRS])))
    return G.RegionMatrices(
        proj_mat=f32(G.get_proj_mat(dirs)), ellipse_mat=f32(ell),
        ellipse=G.Ellipsoid.from_dense(ell, device), dirs=f32(dirs),
        dirs_inv=f32(np.linalg.pinv(dirs)),
        red_ellipse=G.Ellipsoid.from_diag(red.copy(), device),
        red_ellipse_diag=f32(red), red_ellipse_diag_inv=f32(1.0 / red))


def _embed_fn(p):
    from certifyingfacerecognition_torch.constants import (INP_RESOLS, MEAN,
                                                           STD)
    from certifyingfacerecognition_torch.models.pipeline import frm_apply
    from certifyingfacerecognition_torch.ops.resize import transform_for_frs
    from cfr_bench.reference.precision import F32

    def embed(gen_params, frm_params, w):
        img = synthesize(gen_params, w, p.res, F32)
        x = transform_for_frs(img, INP_RESOLS[p.frs], MEAN, STD)
        return frm_apply(p.frs, frm_params, x, dtype=p.dtype)
    return embed


def pipeline(p, gallery=None):
    from certifyingfacerecognition_torch.models.pipeline import FacePipeline

    pipe = FacePipeline(p.gen_params, p.frm_params, dirs=p.region.dirs.t(),
                        frs_method=p.frs, resolution=p.res, dtype=p.dtype,
                        gallery=gallery, device=p.device)
    pipe.embed_fn = _embed_fn(p)
    return pipe


def dists_fn(p, remat=True):
    from certifyingfacerecognition_torch.ops import distances as D

    embed = _embed_fn(p)

    def dists(params, w):
        e = embed(params["gen"], params["frm"], w).float()
        return D.cdist(e, params["gallery"], p.frs)
    return dists


def stages(p, w):
    return None
'''

TOY_CELLS = {"toy.certify": ("certify-iso", "sg1024-r50.certify"),
             "toy.pgd": ("attack-pgd", "sg1024-r50.pgd")}
SPLIT = ("synthesis_prefix.ms_per_batch", "synthesis_tail.ms_per_batch",
         "synthesis_tail_roofline", "frm.ms_per_batch")


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy family, its boundaries and its configuration in a directory
    of their own, the harness pointed at it for generators; a benchmark
    with a certify and a PGD cell of it, reporting what the r50 cells do."""
    (tmp_path / "toy_z32.py").write_text(TOY)
    rng = np.random.default_rng(7)
    from cfr_bench.reference.pipeline import ATTRS
    for a, _ in ATTRS:
        d = rng.standard_normal((1, 512))
        np.save(tmp_path / f"toy_z_{a}_boundary.npy", d / np.linalg.norm(d))
    r50 = harness.load_json(harness.HERE / "configs"
                            / "stylegan-ffhq1024-arcface-r50.json")
    config = {"name": "toy-z32-arcface-r50", "generator": "toy_z32",
              "resolution": 32, "toy_channels": 32, "toy_convs": 2,
              "z_dim": 512, "frs": "insightface", "frm_arch": "iresnet50",
              "frm_input": 112, "embedding_dim": 512, "dtype": "f32",
              "env": {}, "reduced": [], "limits": r50["limits"]}
    (tmp_path / "toy.json").write_text(json.dumps(config))
    monkeypatch.setitem(families.DIRS, "generator", tmp_path)

    bench = copy.deepcopy(H.bench())
    bench["configs"].append({"name": config["name"], "source": "a test",
                             "file": str(tmp_path / "toy.json"),
                             "reduced": [], "why": "a test"})
    for name, (traffic, like) in TOY_CELLS.items():
        bench["workloads"].append({"name": name, "config": config["name"],
                                   "traffic": traffic, "chips": 1,
                                   "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    return bench, tmp_path / "toy.json"


@pytest.mark.parametrize("cell", list(TOY_CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_toy_family_added_as_files_runs_correct(cell, trace, toy):
    bench, config_file = toy
    entry = {c["name"]: c for c in bench["workloads"]}[cell]
    config = harness.load_json(config_file)
    traffic = harness.load_json(harness.HERE / "traffic"
                                / f"{entry['traffic']}.json")
    ctx, driver = H.tiny_ctx(entry, config, traffic)
    res = harness.run_cell(ctx, 0.0, trace, driver, bench,
                           time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    want = harness.cell_metrics(bench, "per_layer" if trace
                                else "end_to_end", cell)
    got = res["metrics"]
    assert set(got) <= {m["name"] for m in want}
    if not trace:
        assert set(got) == {m["name"] for m in want}
    elif cell == "toy.certify":
        # no split at 256^2: the staged readers find nothing to read
        assert not set(SPLIT) & set(got)
        assert 0 < got["certify.mfu"]["value"] < 100
    else:
        assert 0 < got["attack.mfu"]["value"] < 100
    # the toy's own widths and latents, not StyleGAN's
    z = families.load("generator", "toy_z32").latents(3, ctx.seed,
                                                      torch.device("cpu"))
    assert torch.allclose(z.norm(dim=1), torch.full((3,), math.sqrt(512.0)))
