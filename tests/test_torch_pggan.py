"""The port's PGGAN generator against the JAX package's at 32^2 (the same
random:17 weights through both converters, the same normalised z, the
JAX image transposed from NHWC): f32 to 2e-5 of max(1, max |image|) (the
JAX package's own bound against the reference model); bf16 to 3e-2 of it
against JAX's bf16 (both rewrite upsample + conv3x3 as one transposed
conv, and round in different places) and to 0.05 against the port's own
f32 (the JAX package's bf16 bound). Also preprocess_z, the random state
dict, and the weight loader's PGGAN route (random:17 and an .npz the JAX
package wrote)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import pggan as jpg
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch.models import pggan as tpg
from certifyingfacerecognition_torch.utils import weights as tw

RES = 32


@pytest.fixture(scope="module")
def weights():
    sd = jpg.random_torch_style_state_dict(RES, seed=17)
    z = np.random.default_rng(3).standard_normal((2, 512)).astype(np.float32)
    z = np.asarray(jpg.preprocess_z(jnp.asarray(z)))
    return (sd, jpg.convert_torch_state_dict(sd, RES),
            tpg.convert_torch_state_dict(sd, RES, device="cpu"), z)


def _scaled_err(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale


def _port(params, z, dtype):
    return tpg.apply(params, torch.tensor(z), resolution=RES,
                     dtype=dtype).float().numpy()


def _jax(params, z, dtype):
    img = jpg.apply(params, jnp.asarray(z), resolution=RES, dtype=dtype)
    return np.transpose(np.asarray(img.astype(jnp.float32)), (0, 3, 1, 2))


def test_random_state_dict_equals_jax():
    want = jpg.random_torch_style_state_dict(RES, seed=17)
    got = tpg.random_torch_style_state_dict(RES, seed=17)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_preprocess_z_matches_jax():
    z = np.random.default_rng(0).standard_normal((4, 512)).astype(
        np.float32) * 3.0
    got = tpg.preprocess_z(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpg.preprocess_z(
        jnp.asarray(z))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), np.sqrt(512.0),
                               rtol=1e-6)


def test_apply_f32_matches_jax(weights):
    _, jparams, tparams, z = weights
    got = _port(tparams, z, torch.float32)
    assert got.shape == (2, 3, RES, RES)
    assert _scaled_err(got, _jax(jparams, z, jnp.float32)) <= 2e-5


def test_apply_bf16_matches_jax_and_own_f32(weights):
    _, jparams, tparams, z = weights
    got = _port(tparams, z, torch.bfloat16)
    assert _scaled_err(got, _jax(jparams, z, jnp.bfloat16)) <= 3e-2
    assert _scaled_err(got, _port(tparams, z, torch.float32)) <= 0.05


def test_synthesize_from_z_matches_jax(weights):
    """Normalisation, synthesis and the [0, 1] postprocess, from raw z."""
    _, jparams, tparams, _ = weights
    z = np.random.default_rng(5).standard_normal((2, 512)).astype(np.float32)
    got = tpg.synthesize_from_z(tparams, torch.from_numpy(z),
                                resolution=RES).numpy()
    want = np.transpose(np.asarray(jpg.synthesize_from_z(
        jparams, jnp.asarray(z), resolution=RES)), (0, 3, 1, 2))
    np.testing.assert_allclose(got, want, atol=2e-5)


def _assert_tree_equals_jax(tree, jparams):
    flat, jflat = tw.flatten_params(tree), jw.flatten_params(jparams)
    assert sorted(flat) == sorted(jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_loader_pggan_route_matches_jax(weights, tmp_path):
    _, jparams, _, _ = weights
    got = tw.load_generator_params("random:17", "pggan_celebahq",
                                   resolution=RES, device="cpu")
    _assert_tree_equals_jax(got, jparams)
    _assert_tree_equals_jax(got, jw.load_generator_params(
        "random:17", "pggan_celebahq", resolution=RES))
    path = str(tmp_path / "pggan.npz")
    jw.save_params(path, jparams)
    _assert_tree_equals_jax(tw.load_generator_params(
        path, "pggan_celebahq", resolution=RES, device="cpu"), jparams)


def test_bf16_drift_tracks_jax_at_64():
    """The bf16 path drifts from f32 as the resolution grows, in both
    packages: at 64^2 the port's largest and mean |bf16 - f32| stay
    within 1.25x the JAX package's own."""
    res = 64
    sd = jpg.random_torch_style_state_dict(res, seed=0)
    jparams = jpg.convert_torch_state_dict(sd, res)
    tparams = tpg.convert_torch_state_dict(sd, res, device="cpu")
    z = np.random.default_rng(3).standard_normal((2, 512)).astype(np.float32)
    z = np.asarray(jpg.preprocess_z(jnp.asarray(z)))
    run = {"jax": lambda dt: np.transpose(np.asarray(jpg.apply(
               jparams, jnp.asarray(z), resolution=res,
               dtype=dt).astype(jnp.float32)), (0, 3, 1, 2)),
           "port": lambda dt: tpg.apply(
               tparams, torch.tensor(z), resolution=res,
               dtype=torch.float32 if dt == jnp.float32
               else torch.bfloat16).float().numpy()}
    drift = {}
    for name, fn in run.items():
        f32 = fn(jnp.float32)
        d = np.abs(fn(jnp.bfloat16) - f32) / max(1.0, np.abs(f32).max())
        drift[name] = (d.max(), d.mean())
    assert drift["port"][0] <= 1.25 * drift["jax"][0]
    assert drift["port"][1] <= 1.25 * drift["jax"][1]
