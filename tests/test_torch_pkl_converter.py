"""The port's tools/pkl_converter.py and tools/validate_conversion.py
against the JAX package's, on synthetic official-style snapshots (dnnlib
Network objects holding TF-layout variables, built as
tests/test_pkl_converter.py builds them) at 128^2 (StyleGAN) and 32^2
(PGGAN):

* the port's .npz equals the JAX converter's, key for key and array for
  array (exact, dtypes included);
* load_pkl_variables works with no dnnlib module importable, and the
  averaged generator's variables override the stale copies;
* synthesis from the converted parameters equals the state-dict route
  (convert_torch_state_dict of the same random state dict) to 1e-5, f32;
* validate_conversion returns 0 with OK_NO_TORCH_ORACLE (no --reference),
  and 2 for an unknown md5 without --allow-unknown-pkl;
* --fixture: a fixture made with the JAX package's FaceNet (apply on its
  random:0 weights, saved as a .pth) validates OK on the port's FaceNet,
  and the same fixture with its embeddings shifted by 10 x --atol fails.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import json
import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import facenet as jfn
from certifyingfacerecognition_tpu.models import pggan as jpg
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.tools import pkl_converter as JPC
from certifyingfacerecognition_torch.models import pggan as tpg
from certifyingfacerecognition_torch.models import stylegan as tsg
from certifyingfacerecognition_torch.tools import pkl_converter as TPC
from certifyingfacerecognition_torch.tools import validate_conversion as TVC
from certifyingfacerecognition_torch.utils import weights as tw

RES = 128
PGGAN_RES = 32
torch.set_num_threads(1)


def _torch_sd_to_tf_vars(sd, resolution):
    """Inverse of the converter's relayout: the TF-side variables."""
    tf_vars = {}
    for torch_name, tf_name in TPC.stylegan_tf_to_torch_names(resolution):
        var = np.asarray(sd[torch_name], np.float32)
        if "linear.weight" in torch_name:
            var = var.T
        elif torch_name.endswith("conv.weight"):
            var = var.transpose(2, 3, 1, 0)          # OIHW -> HWIO
        if torch_name == "synthesis.layer0.first_layer":
            var = var[0]                              # [C,4,4] TF const
        if tf_name.startswith("noise"):
            h, w = var.shape[-2:]
            var = var.reshape(1, h, w, 1)             # NHWC TF noise
        tf_vars[tf_name] = var
    return tf_vars


def _pggan_torch_sd_to_tf_vars(sd, resolution):
    """Inverse of the PGGAN relayout."""
    tf_vars = {}
    for torch_name, tf_name in TPC.pggan_tf_to_torch_names(resolution):
        var = np.asarray(sd[torch_name], np.float32)
        if torch_name == "layer0.conv.weight":
            var = var[:, :, ::-1, ::-1].transpose(1, 0, 2, 3)
            var = var.reshape(var.shape[0], -1).copy()
        elif torch_name.endswith("conv.weight"):
            var = var.transpose(2, 3, 1, 0)               # OIHW -> HWIO
        tf_vars[tf_name] = var
    return tf_vars


def _write_fake_official_pkl(path, tf_vars):
    """Pickle a (G, D, Gs)-style tuple of fake dnnlib Network objects: the
    Dense* variables, halved, in a mapping component of Gs (so the values
    passed in are doubled first), and a stale G of zeros before it."""
    tf_vars = {k: (v * 2 if "Dense" in k else v) for k, v in tf_vars.items()}
    dnnlib = types.ModuleType("dnnlib")
    tflib = types.ModuleType("dnnlib.tflib")
    network_mod = types.ModuleType("dnnlib.tflib.network")

    class Network:
        def __init__(self, variables, components=None):
            self.variables = variables
            self.components = components or {}

        def __getstate__(self):
            return {"version": 3, "variables": self.variables,
                    "components": self.components}

    Network.__module__ = "dnnlib.tflib.network"
    Network.__qualname__ = "Network"
    network_mod.Network = Network
    tflib.network = network_mod
    dnnlib.tflib = tflib
    sys.modules.update({"dnnlib": dnnlib, "dnnlib.tflib": tflib,
                        "dnnlib.tflib.network": network_mod})
    try:
        items = sorted(tf_vars.items())
        mapping = Network([(k, v * 0.5) for k, v in items if "Dense" in k])
        stale = Network([(k, np.zeros_like(v)) for k, v in items[:4]])
        gs = Network([(k, v) for k, v in items if "Dense" not in k],
                     components={"mapping": mapping})
        with open(path, "wb") as f:
            pickle.dump((stale, None, gs), f, protocol=2)
    finally:
        for m in ("dnnlib.tflib.network", "dnnlib.tflib", "dnnlib"):
            sys.modules.pop(m, None)


@pytest.fixture(scope="module")
def stylegan_pkl(tmp_path_factory):
    sd = jsg.random_torch_style_state_dict(RES, seed=4)
    path = str(tmp_path_factory.mktemp("pkl") / "fake-stylegan-128.pkl")
    _write_fake_official_pkl(path, _torch_sd_to_tf_vars(sd, RES))
    return path, sd


@pytest.fixture(scope="module")
def pggan_pkl(tmp_path_factory):
    sd = jpg.random_torch_style_state_dict(PGGAN_RES, seed=5)
    path = str(tmp_path_factory.mktemp("pkl") / "fake-pggan-32.pkl")
    _write_fake_official_pkl(path, _pggan_torch_sd_to_tf_vars(sd, PGGAN_RES))
    return path, sd


def _assert_npz_equal(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("gan", ["stylegan", "pggan"])
def test_npz_equals_jax_converter(gan, stylegan_pkl, pggan_pkl, tmp_path):
    path, _ = stylegan_pkl if gan == "stylegan" else pggan_pkl
    res = RES if gan == "stylegan" else PGGAN_RES
    want, got = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    getattr(JPC, f"convert_{gan}_pkl")(path, want, resolution=res)
    TPC.main([path, got, str(res), gan])
    _assert_npz_equal(got, want)


def test_pkl_loads_without_dnnlib(stylegan_pkl):
    path, _ = stylegan_pkl
    assert "dnnlib" not in sys.modules
    tf_vars = TPC.load_pkl_variables(path)
    assert "dlatent_avg" in tf_vars and "Dense0/weight" in tf_vars
    assert "dnnlib" not in sys.modules
    # the averaged generator's variables override the stale G's zeros
    assert float(np.abs(tf_vars["dlatent_avg"]).sum()) > 0


@pytest.mark.parametrize("gan", ["stylegan", "pggan"])
def test_synthesis_matches_state_dict_route(gan, stylegan_pkl, pggan_pkl,
                                            tmp_path):
    path, sd = stylegan_pkl if gan == "stylegan" else pggan_pkl
    out = str(tmp_path / "conv.npz")
    rng = np.random.default_rng(11)
    if gan == "stylegan":
        TPC.convert_stylegan_pkl(path, out, resolution=RES)
        w = torch.tensor(rng.standard_normal((2, 512)), dtype=torch.float32)

        def synth(params):
            return tsg.synthesize_from_w(params, w, resolution=RES)

        want = synth(tsg.convert_torch_state_dict(sd, RES, device="cpu"))
    else:
        TPC.convert_pggan_pkl(path, out, resolution=PGGAN_RES)
        z = torch.tensor(rng.standard_normal((2, 512)), dtype=torch.float32)

        def synth(params):
            return tpg.synthesize_from_z(params, z, resolution=PGGAN_RES)

        want = synth(tpg.convert_torch_state_dict(sd, PGGAN_RES,
                                                  device="cpu"))
    with torch.inference_mode():
        got = synth(tw.load_params(out, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def _verdict(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_validate_conversion_no_oracle(stylegan_pkl, tmp_path, capsys):
    path, _ = stylegan_pkl
    out = str(tmp_path / "validated.npz")
    rc = TVC.main(["--pkl", path, "--model", "stylegan_ffhq",
                   "--resolution", str(RES), "--test-num", "2",
                   "--allow-unknown-pkl", "--out", out, "--device", "cpu"])
    verdict = _verdict(capsys)
    assert rc == 0 and verdict["status"] == "OK_NO_TORCH_ORACLE", verdict
    assert verdict["torch_parity"] is None
    assert verdict["output_shape"] == [2, 3, RES, RES]
    assert np.isfinite(verdict["output_std"]) and verdict["output_std"] > 0
    assert "jax_output_shape" not in verdict
    with np.load(out) as sd:
        assert len(sd.files) == verdict["converted_leaves"]


def test_validate_conversion_refuses_unknown_md5(stylegan_pkl, capsys):
    path, _ = stylegan_pkl
    rc = TVC.main(["--pkl", path, "--model", "stylegan_ffhq",
                   "--resolution", str(RES), "--device", "cpu"])
    verdict = _verdict(capsys)
    assert rc == 2 and verdict["status"] == "UNKNOWN_PKL"
    assert verdict["md5"] == TVC.md5_file(path)


@pytest.fixture(scope="module")
def facenet_fixture(tmp_path_factory):
    """A .pth of the JAX package's FaceNet random:0 state dict, and the
    fixture fields of the JAX FaceNet's embeddings of two seeded inputs."""
    d = tmp_path_factory.mktemp("facenet")
    sd = jfn.random_torch_style_state_dict(seed=0)
    pth = str(d / "facenet.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pth)
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (2, 3, 160, 160)).astype(
        np.float32)
    embs = np.asarray(jfn.apply(jfn.convert_torch_state_dict(sd),
                                jnp.asarray(x.transpose(0, 2, 3, 1))),
                      np.float32)
    return pth, dict(inputs=x, embs=embs, package_version="jax",
                     weights_sha256=TVC.sha256_file(pth))


@pytest.mark.parametrize("shift", [0.0, 10.0])
def test_facenet_fixture(facenet_fixture, tmp_path, capsys, shift):
    pth, fields = facenet_fixture
    atol = 5e-4
    fixture = str(tmp_path / "fixture.npz")
    np.savez(fixture, **dict(fields, embs=fields["embs"] + shift * atol))
    rc = TVC.main(["--facenet-weights", pth, "--fixture", fixture,
                   "--atol", str(atol), "--device", "cpu"])
    verdict = _verdict(capsys)
    if shift:
        assert rc == 1 and verdict["status"] == "PARITY_FAIL", verdict
    else:
        assert rc == 0 and verdict["status"] == "OK", verdict
        assert verdict["max_abs"] <= 2e-5
