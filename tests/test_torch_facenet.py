"""The port's FaceNet (certifyingfacerecognition_torch.models.facenet)
against the JAX package's, on the CPU, with numpy-seeded inputs.

* apply at 160^2, batch 2: f32 to 2e-5 absolute on the unit-norm
  embedding; bf16 to 3e-3 absolute (both packages round the ~130
  convolutions to bf16, in another order: 1.2e-3 measured, about the size
  of either bf16 path's distance to f32), and no further from the f32
  embedding than twice the JAX bf16 path's distance plus 1e-4.
* the conversion: random_torch_style_state_dict gives the JAX package's
  arrays, and the folded tree equals the JAX tree leaf for leaf (1e-7),
  from that state dict and from tests/torch_facenet_oracle.py's own
  state_dict (num_batches_tracked entries included); the port's
  embedding of the oracle's weights equals the oracle's forward (2e-5).
* the pipeline's facenet embed at 32^2 synthesis, f32, against the JAX
  make_lat2embs (2e-5 absolute).
* load_frm_params('random:3', 'facenet') is facenet.random_params(3); a
  .pth checkpoint is converted, cached under the JAX package's cache name
  and read back from the cache by both packages.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import facenet as jfn
from certifyingfacerecognition_tpu.models import pipeline as jpl
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch.models import facenet as tfn
from certifyingfacerecognition_torch.models import pipeline as tpl
from certifyingfacerecognition_torch.utils import weights as tw
from torch_facenet_oracle import InceptionResnetV1Oracle

torch.set_num_threads(1)


def _images(seed=5, b=2):
    """[b, 160, 160, 3] NHWC images in [-1, 1] (normalised pixels)."""
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (b, 160, 160, 3)).astype(np.float32)


def _port(jparams):
    return tw.params_from_jax(jw.flatten_params(jparams), device="cpu")


def _apply_both(jparams, x, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jfn.apply(jparams, jnp.asarray(x), dtype=jdt))
    got = tfn.apply(_port(jparams), torch.tensor(x).permute(0, 3, 1, 2),
                    dtype=dtype).numpy()
    return got, want


@pytest.fixture(scope="module")
def jparams():
    return jfn.random_params(0)


@pytest.fixture(scope="module")
def f32_pair(jparams):
    return _apply_both(jparams, _images(), torch.float32)


def test_facenet_f32_matches_jax(f32_pair):
    got, want = f32_pair
    assert got.shape == (2, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_facenet_bf16_matches_jax(jparams, f32_pair):
    got, want = _apply_both(jparams, _images(), torch.bfloat16)
    ref = f32_pair[1]
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-3)
    assert np.abs(got - ref).max() <= 2 * np.abs(want - ref).max() + 1e-4


def _assert_trees_equal(got, want):
    got, want = tw.flatten_params(got), jw.flatten_params(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=1e-7, err_msg=k)


def test_random_state_dict_and_conversion_match_jax():
    sd = tfn.random_torch_style_state_dict(seed=7)
    want_sd = jfn.random_torch_style_state_dict(seed=7)
    assert list(sd) == list(want_sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want_sd[k])
    _assert_trees_equal(tfn.convert_state_dict_np(sd),
                        jfn.convert_torch_state_dict(want_sd))


def test_oracle_state_dict_conversion_and_forward():
    torch.manual_seed(11)
    model = InceptionResnetV1Oracle().eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert any("num_batches_tracked" in k for k in sd)
    tparams = tfn.convert_torch_state_dict(sd, device="cpu")
    _assert_trees_equal(tparams, jfn.convert_torch_state_dict(sd))
    x = torch.tensor(_images(seed=6)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = model(x).numpy()
    np.testing.assert_allclose(tfn.apply(tparams, x).numpy(), want, rtol=0,
                               atol=2e-5)


def test_pipeline_facenet_embed_matches_jax(jparams):
    res = 32
    jgen = jsg.random_params(res, seed=2)
    w = np.random.default_rng(3).standard_normal((2, 512)).astype(np.float32)
    want = np.asarray(jpl.make_lat2embs("facenet", res)(jgen, jparams,
                                                        jnp.asarray(w)))
    tgen = tw.params_from_jax(jw.flatten_params(jgen), device="cpu")
    with torch.no_grad():
        got = tpl.make_lat2embs("facenet", res)(tgen, _port(jparams),
                                                torch.tensor(w)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_load_frm_params_random_facenet():
    got = tw.load_frm_params("random:3", "facenet", device="cpu")
    _assert_trees_equal(got, jfn.random_params(3))


def test_load_frm_params_facenet_checkpoint(tmp_path):
    """A facenet_pytorch-style .pth: converted to the JAX package's tree,
    cached beside it under the JAX package's cache name, and read back
    from the cache (.npz) the second time."""
    import os

    from certifyingfacerecognition_tpu.utils import weights as jweights

    sd = jfn.random_torch_style_state_dict(seed=4)
    path = str(tmp_path / "facenet.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    want = jfn.convert_torch_state_dict(sd)
    _assert_trees_equal(tw.load_frm_params(path, "facenet", device="cpu"),
                        want)
    cache = f"{path}.cfr-facenet-{int(os.path.getmtime(path))}.npz"
    assert sorted(os.listdir(tmp_path)) == sorted(["facenet.pth",
                                                   os.path.basename(cache)])
    _assert_trees_equal(tw.load_frm_params(path, "facenet", device="cpu"),
                        want)
    # the JAX package reads the port's cache file as its own
    _assert_trees_equal(jweights.load_frm_params(path, "facenet"), want)
