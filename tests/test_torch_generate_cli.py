"""The port's generation CLI against the JAX CLI, with the same argv at
16^2 (--resolution 16, random weights, f32; the port with --device cpu):
StyleGAN in Z, W and WP space (WP without truncation) and with -I (codes
only), PGGAN in Z, PGGAN
with -I (which still writes its images) and codes loaded with -i (for
PGGAN normalised onto the sqrt(512) sphere before use and saving).

Checks: z.npy / w.npy / wp.npy to 1e-5; the PNG pixels, decoded with
PIL, equal to the JAX CLI's except for at most 1 level on at most 0.1 %
of them (f32 rounding order flips a value at a truncation boundary);
the same files. The one file left out of the comparison is log.txt: the
JAX CLI writes it only on the first run of its process (its logger is
then kept), the port on every run."""

import os
import os.path as osp

import numpy as np
import pytest
import torch
from PIL import Image

from certifyingfacerecognition_tpu.cli import generate_data as jcli
from certifyingfacerecognition_torch.cli import generate_data as tcli
from certifyingfacerecognition_torch.utils import png

torch.set_num_threads(1)

CASES = {
    "stylegan-z": ["-m", "stylegan_ffhq", "-s", "z", "-n", "3",
                   "--batch-size", "2"],
    "stylegan-w": ["-m", "stylegan_ffhq", "-s", "w", "-n", "2"],
    "stylegan-wp": ["-m", "stylegan_ffhq", "-s", "WP", "-n", "2"],
    "stylegan-no-images": ["-m", "stylegan_ffhq", "-s", "w", "-n", "2",
                           "-I"],
    "pggan-z": ["-m", "pggan_celebahq", "-n", "2", "--seed", "5"],
    "pggan-loaded-no-images": ["-m", "pggan_celebahq", "-I", "-i",
                               "{codes}"],
    "stylegan-loaded": ["-m", "stylegan_ffhq", "-s", "z", "-i", "{codes}"],
}


def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f != "log.txt")


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax_cli(tmp_path, case):
    codes = str(tmp_path / "codes.npy")
    np.save(codes, np.random.default_rng(9).standard_normal(
        (2, 512)).astype(np.float32) * 2.0)
    argv = [a.format(codes=codes) for a in CASES[case]] + [
        "--resolution", "16"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcli.main(argv + ["-o", out_j])
    tcli.main(argv + ["-o", out_t, "--device", "cpu"])

    files = _files(out_j)
    assert files == _files(out_t)
    assert osp.isfile(osp.join(out_t, "log.txt"))
    npys = [f for f in files if f.endswith(".npy")]
    assert npys, files
    for f in npys:
        np.testing.assert_allclose(np.load(osp.join(out_t, f)),
                                   np.load(osp.join(out_j, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    pngs = [f for f in files if f.endswith(".png")]
    assert bool(pngs) == ("-I" not in argv or "pggan" in argv[1])
    for f in pngs:
        got = np.asarray(Image.open(osp.join(out_t, f))).astype(np.int64)
        want = np.asarray(Image.open(osp.join(out_j, f))).astype(np.int64)
        assert got.shape == want.shape == (16, 16, 3)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, f


def test_png_encoder_round_trips_through_pil(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, rgb)
    img = Image.open(path)
    assert img.mode == "RGB" and img.size == (7, 5)
    np.testing.assert_array_equal(np.asarray(img), rgb)
    with pytest.raises(ValueError):
        png.encode_png(rgb.astype(np.float32))
