"""Identity-generation CLI (port of certifyingfacerecognition_tpu/cli/
generate_data.py): samples N latent codes in Z, W or WP space, synthesizes
their images in batches and writes ``ims/%06d.png`` plus ``z.npy`` /
``w.npy`` / ``wp.npy``, on one CUDA device by default (--device cpu runs
on the CPU).

Same flags, defaults, codes and artifacts as the JAX CLI:
  * codes come from ``np.random.default_rng(--seed)`` on the host, in the
    JAX CLI's draw order and shapes (WP: [num, L, 512]); PGGAN codes, drawn
    or loaded with -i, are normalised onto the sqrt(512) sphere;
  * StyleGAN Z codes are normalised onto that sphere, then mapped; WP
    codes are used as they are (no truncation); mapping and truncation run
    in f32 whatever --dtype says, synthesis in --dtype (bf16 with
    CFR_TAIL=bc runs the hand-written chain tail);
  * -I skips StyleGAN's images; PGGAN writes its images regardless;
  * pixels are (clip(image, 0, 1) * 255) truncated to uint8, computed in
    the image's dtype.
PNGs are written by the port's own encoder (utils/png.py).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from time import time

import numpy as np
import torch

from ..constants import (MODEL_POOL, STYLEGAN_TRUNCATION_LAYERS,
                         STYLEGAN_TRUNCATION_PSI)
from ..utils import weights as W
from ..utils.device import f32_exact_math, resolve_device
from ..utils.logger import close_logger, setup_logger
from ..utils.png import write_png


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate images with given model.")
    parser.add_argument("-m", "--model_name", type=str, required=True,
                        choices=list(MODEL_POOL),
                        help="Name of the model for generation. (required)")
    parser.add_argument("-o", "--output_dir", type=str, required=True,
                        help="Directory to save the output results. "
                             "(required)")
    parser.add_argument("-i", "--latent_codes_path", type=str, default="",
                        help="If specified, load latent codes instead of "
                             "sampling. (optional)")
    parser.add_argument("-n", "--num", type=int, default=1,
                        help="Number of images to generate. (default: 1)")
    parser.add_argument("-s", "--latent_space_type", type=str, default="z",
                        choices=["z", "Z", "w", "W", "wp", "wP", "Wp", "WP"],
                        help="Latent space used in Style GAN. (default: Z)")
    parser.add_argument("-I", "--generate_image", action="store_false",
                        help="If specified, skip generating images.")
    parser.add_argument("--weights", type=str, default="random",
                        help=".npz/.pth generator weights or 'random[:seed]'")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=2,
                        help="Sampling seed (reference default: 2)")
    parser.add_argument("--dtype", type=str, default="fp32",
                        choices=["fp32", "bf16"])
    parser.add_argument("--resolution", type=int, default=None,
                        help="Override synthesis resolution (debug/smoke)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (cuda needs a CUDA GPU)")
    return parser


def sample_codes(args, gan_type: str, space: str, resolution: int
                 ) -> np.ndarray:
    """The latent codes [num, 512] (WP: [num, L, 512]), loaded from -i or
    drawn from default_rng(--seed); PGGAN's normalised."""
    from ..models import pggan, stylegan

    rng = np.random.default_rng(args.seed)
    if args.latent_codes_path and osp.isfile(args.latent_codes_path):
        codes = np.load(args.latent_codes_path).astype(np.float32)
    elif space == "wp" and gan_type == "stylegan":
        codes = rng.standard_normal(
            (args.num, stylegan.num_layers(resolution), 512)).astype(
                np.float32)
    else:
        codes = rng.standard_normal((args.num, 512)).astype(np.float32)
    if gan_type == "pggan":
        codes = pggan.preprocess_z(torch.from_numpy(codes)).numpy()
    if space == "wp" and gan_type == "stylegan":
        codes = codes.reshape(codes.shape[0], -1, 512)
    return codes


def to_pixels(img: torch.Tensor) -> np.ndarray:
    """[B, 3, H, W] image in [0, 1] -> [B, H, W, 3] uint8 on the host:
    clip, x 255 in the image's dtype, truncate."""
    px = (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8)
    return px.permute(0, 2, 3, 1).cpu().numpy()


def main(argv=None) -> None:
    from ..models import pggan, stylegan

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    settings = MODEL_POOL[args.model_name]
    resolution = args.resolution or settings["resolution"]
    gan_type = settings["gan_type"]
    space = args.latent_space_type.lower()
    if gan_type == "pggan":
        assert space == "z", "PGGAN only supports Z space"
    write_images = args.generate_image or gan_type == "pggan"

    logger = setup_logger(args.output_dir, logger_name="generate_data_torch",
                          allow_existing=True)
    try:
        logger.info(f"Initializing {args.model_name} generator.")
        params = W.load_generator_params(args.weights, args.model_name,
                                         resolution=resolution, device=device)
        dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
        f32_exact_math()           # mapping and truncation run in full f32
        os.makedirs(osp.join(args.output_dir, "ims"), exist_ok=True)
        if args.latent_codes_path and osp.isfile(args.latent_codes_path):
            logger.info(f"Preparing latent codes from "
                        f"{args.latent_codes_path}")
        else:
            logger.info(f"Sampling {args.num} latent codes randomly.")
        codes = sample_codes(args, gan_type, space, resolution)
        num = codes.shape[0]

        results, images = {}, []
        t0 = time()
        for s in range(0, num, args.batch_size):
            batch = torch.from_numpy(codes[s:s + args.batch_size]).to(device)
            with torch.inference_mode():
                if gan_type == "pggan":
                    img = pggan.synthesize_from_z(params, batch,
                                                  resolution=resolution,
                                                  dtype=dtype)
                    results.setdefault("z", []).append(batch)
                else:
                    if space == "wp":
                        wp = batch
                    else:
                        if space == "z":
                            z = batch / torch.linalg.vector_norm(
                                batch, dim=1, keepdim=True) * np.sqrt(512.0)
                            w = stylegan.mapping_apply(params, z)
                            results.setdefault("z", []).append(z)
                        else:
                            w = batch
                        wp = stylegan.truncation_apply(
                            params, w, resolution=resolution,
                            truncation_psi=STYLEGAN_TRUNCATION_PSI,
                            truncation_layers=STYLEGAN_TRUNCATION_LAYERS)
                        results.setdefault("w", []).append(w)
                    results.setdefault("wp", []).append(wp)
                    img = stylegan.postprocess(stylegan.synthesis_apply(
                        params, wp, resolution=resolution,
                        dtype=dtype)) if args.generate_image else None
                if write_images:
                    images.append(to_pixels(img))
            logger.info(f"  synthesized {min(s + args.batch_size, num)}/"
                        f"{num}")

        if write_images:
            for i, im in enumerate(np.concatenate(images)[:num]):
                write_png(osp.join(args.output_dir, "ims", f"{i:06d}.png"),
                          im)
        for space_name, arrs in results.items():
            arr = torch.cat(arrs).cpu().numpy()[:num]
            np.save(osp.join(args.output_dir, f"{space_name}.npy"), arr)
            logger.info(f"Saved {space_name}.npy {arr.shape}")
        logger.info(f"Done in {time() - t0:3.1f}s")
    finally:
        close_logger(logger)


if __name__ == "__main__":
    main()
