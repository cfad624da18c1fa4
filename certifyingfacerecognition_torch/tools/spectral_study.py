"""Power-spectrum calibration of the PSD-matched proxy weights (port of
certifyingfacerecognition_tpu/tools/spectral_study.py).

Random StyleGAN weights do not give images with the natural-image ~1/f^2
power spectrum (radial log-log slope ~ -2). ``stylegan.random_params(...,
spectral_gamma=gamma)`` shapes the spectrum; this tool calibrates gamma:

  for each gamma in SS_GAMMAS, synthesize SS_IMAGES identities at
  SS_RESOLUTION, average the radially binned power spectrum of the
  grayscale images over the batch, fit the log-log slope over the
  mid-frequency decade, and print it (one JSON line per gamma), then the
  gamma whose slope lies nearest -2.

Feed the chosen gamma to the decision study:
``RS_SPECTRAL_GAMMA=<gamma> python -m
certifyingfacerecognition_torch.tools.resolution_study``.

In bf16 with CFR_TAIL=bc the synthesis runs through the chain kernels
(ops/synthesis_tail_bc.py): all four at 1024^2, all but conv_fused at
512^2.

Usage: python -m certifyingfacerecognition_torch.tools.spectral_study
Env: SS_GAMMAS ("0,-0.25,-0.5,-0.75,-1"), SS_RESOLUTION (1024),
SS_IMAGES (8), SS_DTYPE (bf16), SS_SEED (0). ``--device`` (default cuda;
cpu runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def radial_psd_slope(images: np.ndarray, f_lo: int = 4,
                     f_hi_frac: float = 0.25):
    """(slope, (freqs, power)): log-log slope of the radially binned power
    spectrum of [B, H, W] or [B, H, W, 3] images over f in
    [f_lo, H * f_hi_frac].

    Natural images: slope ~ -2 (the 1/f^2 law); white noise: ~ 0. The fit
    window leaves out the DC and low bins (the global face layout, few
    samples per bin) and the corner frequencies (anisotropic sampling of
    the square grid).
    """
    x = np.asarray(images, np.float32)
    if x.ndim == 4 and x.shape[-1] == 3:
        x = x.mean(axis=-1)                       # grayscale
    B, H, W = x.shape
    x = x - x.mean(axis=(1, 2), keepdims=True)
    # A Hann window removes the spectral leakage of the non-periodic image
    # borders (a hard edge alone gives a false 1/f^2 pedestal).
    win = np.hanning(H)[:, None] * np.hanning(W)[None, :]
    F = np.fft.fftshift(np.fft.fft2(x * win), axes=(1, 2))
    P = (np.abs(F) ** 2).mean(axis=0)
    fy = np.fft.fftshift(np.fft.fftfreq(H)) * H
    fx = np.fft.fftshift(np.fft.fftfreq(W)) * W
    r = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    f_hi = int(H * f_hi_frac)
    bins = np.arange(1, f_hi + 1)
    idx = np.digitize(r.ravel(), bins)
    power = np.array([P.ravel()[idx == i].mean()
                      for i in range(f_lo, f_hi)])
    freqs = bins[f_lo:f_hi].astype(np.float64) - 0.5
    valid = power > 0
    slope = np.polyfit(np.log(freqs[valid]), np.log(power[valid]), 1)[0]
    return float(slope), (freqs, power)


def measure_gamma(gamma: float, resolution: int, n_images: int,
                  dtype=torch.bfloat16, seed: int = 0, device="cuda"):
    """PSD slope of ``n_images`` identities synthesized at ``resolution``
    with random_params(seed, realistic=True, spectral_gamma=gamma)."""
    from ..models import stylegan
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    params = stylegan.random_params(resolution, seed=seed, realistic=True,
                                    device=dev, spectral_gamma=gamma)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n_images, 512)).astype(np.float32)
    z = z / np.linalg.norm(z, axis=1, keepdims=True) * np.sqrt(512)
    with torch.inference_mode():
        w = stylegan.mapping_apply(params, torch.as_tensor(z, device=dev))
        imgs = stylegan.synthesize_from_w(params, w, resolution=resolution,
                                          dtype=dtype)
    # [B, 3, H, W] -> [B, H, W, 3], the layout radial_psd_slope averages
    slope, _ = radial_psd_slope(imgs.float().permute(0, 2, 3, 1).cpu()
                                .numpy())
    return slope


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"], help="cuda needs a CUDA GPU")
    args = p.parse_args(argv)
    from ..utils.device import device_name

    kind = device_name(args.device)
    gammas = [float(g) for g in os.environ.get(
        "SS_GAMMAS", "0,-0.25,-0.5,-0.75,-1").split(",")]
    resolution = int(os.environ.get("SS_RESOLUTION", "1024"))
    n_images = int(os.environ.get("SS_IMAGES", "8"))
    dtype = torch.bfloat16 if os.environ.get("SS_DTYPE", "bf16") == "bf16" \
        else torch.float32
    seed = int(os.environ.get("SS_SEED", "0"))

    best = None
    for g in gammas:
        slope = measure_gamma(g, resolution, n_images, dtype, seed,
                              args.device)
        print(json.dumps({"gamma": g, "resolution": resolution,
                          "psd_slope": round(slope, 3),
                          "target": -2.0, "device": kind}), flush=True)
        if best is None or abs(slope + 2.0) < abs(best[1] + 2.0):
            best = (g, slope)
    print(json.dumps({"chosen_gamma": best[0],
                      "chosen_slope": round(best[1], 3),
                      "device": kind}), flush=True)


if __name__ == "__main__":
    main()
