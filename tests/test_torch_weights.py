"""Weight generation and the carry-across from the JAX package: the port's
random state dicts must equal the JAX package's array for array (same
numpy RNG call order), and params_from_jax must rebuild the JAX tree."""

import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import iresnet as jir
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch.models import iresnet as tir
from certifyingfacerecognition_torch.models import stylegan as tsg
from certifyingfacerecognition_torch.utils import weights as tw


def _assert_same_dict(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("resolution", [32, 128])
def test_stylegan_random_state_dict_equals_jax(resolution):
    _assert_same_dict(tsg.random_torch_style_state_dict(resolution, seed=5),
                      jsg.random_torch_style_state_dict(resolution, seed=5))


def test_stylegan_realistic_state_dict_equals_jax():
    _assert_same_dict(
        tsg.random_torch_style_state_dict(64, seed=2, realistic=True),
        jsg.random_torch_style_state_dict(64, seed=2, realistic=True))


@pytest.mark.parametrize("realistic", [False, True])
def test_iresnet_random_state_dict_equals_jax(realistic):
    _assert_same_dict(
        tir.random_torch_style_state_dict("iresnet18", seed=4,
                                          realistic=realistic),
        jir.random_torch_style_state_dict("iresnet18", seed=4,
                                          realistic=realistic))


def _tree_equal(port_tree, jax_flat):
    flat = tw.flatten_params(port_tree)
    assert sorted(flat) == sorted(jax_flat)
    for k, v in jax_flat.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_params_from_jax_round_trips_stylegan_and_iresnet():
    jflat = jw.flatten_params(jsg.random_params(32, seed=1))
    _tree_equal(tw.params_from_jax(jflat, device="cpu"), jflat)
    # the port's own converter builds the same tree
    _tree_equal(tsg.random_params(32, seed=1, device="cpu"), jflat)

    sd = jir.random_torch_style_state_dict("iresnet18", seed=0)
    jflat = jw.flatten_params(jir.convert_torch_state_dict(sd, "iresnet18"))
    tree = tw.params_from_jax(jflat, device="cpu")
    assert isinstance(tree["stages"], list) and len(tree["stages"]) == 4
    _tree_equal(tree, jflat)
    _tree_equal(tir.convert_torch_state_dict(sd, "iresnet18", device="cpu"),
                jflat)


def test_npz_written_by_jax_loads_in_port(tmp_path):
    path = str(tmp_path / "gen.npz")
    jparams = jsg.random_params(16, seed=3)
    jw.save_params(path, jparams)
    _tree_equal(tw.load_params(path, device="cpu"),
                jw.flatten_params(jparams))
    # and the port writes the same flat layout back
    out = str(tmp_path / "gen_port.npz")
    tw.save_params(out, tw.load_params(path, device="cpu"))
    with np.load(out) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_pth_checkpoint_converts_like_jax(tmp_path):
    sd = jir.random_torch_style_state_dict("iresnet50", seed=7)
    path = str(tmp_path / "backbone.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    tree = tw.load_frm_params(path, device="cpu")
    _tree_equal(tree, jw.flatten_params(jir.convert_torch_state_dict(sd)))


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.load_generator_params("random:0", resolution=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.params_from_jax({"a": np.zeros(2, np.float32)})
