"""Real-weight conversion validation (port of certifyingfacerecognition_tpu/
tools/validate_conversion.py). Given an official pkl, it

  1. md5-fingerprints the file against the snapshot the reference pipeline
     documents;
  2. converts it with the stub unpickler (tools/pkl_converter.py, no
     TensorFlow needed);
  3. loads the converted weights into the port's generator and
     synthesizes ``--test-num`` images at full resolution in f32 (the
     plain parity path) on ``--device`` (default cuda);
  4. with ``--reference <dir of the reference repo>``, builds the
     reference's torch generator from the same converted state dict and
     reports the mean/max abs output distance (the analogue of the
     reference's own conversion self-test). Without the flag that
     comparison is skipped and the verdict is OK_NO_TORCH_ORACLE.

Usage:
    python -m certifyingfacerecognition_torch.tools.validate_conversion \\
        --pkl karras2019stylegan-ffhq-1024x1024.pkl \\
        [--model stylegan_ffhq] [--resolution 1024] [--test-num 4] \\
        [--reference <reference repo>] [--out converted.npz]

FaceNet external-truth runbook (real-weight validation anchored to the
genuine facenet_pytorch package, not to a self-authored oracle):

  1. On a machine WITH facenet_pytorch installed:
         python -m certifyingfacerecognition_torch.tools.validate_conversion \\
             --make-facenet-fixture fixture_vggface2.npz \\
             [--facenet-weights <state_dict.pth>]   # default: pretrained
     This runs the package's model in eval mode on 8 seeded inputs and
     stores {inputs, embs, weights_sha256} plus the package version.
  2. Copy the fixture (and the weights .pth) next to this repo and run:
         python -m certifyingfacerecognition_torch.tools.validate_conversion \\
             --facenet-weights <state_dict.pth> --fixture fixture_vggface2.npz
     The port's models/facenet.py must reproduce the fixture's embeddings
     within --atol, and the weights file must match the fixture's sha256.

Exit code 0 with one JSON verdict line on success; non-zero on fingerprint
mismatch (override with --allow-unknown-pkl) or parity failure.

Known official snapshot fingerprints (md5):
  karras2019stylegan-ffhq-1024x1024.pkl      5a20ed46ea6494a9e969db2f6b97a88a
      (documented by the reference's README)
  karras2018iclr-celebahq-1024x1024.pkl      (PGGAN; no md5 published by
      the reference: pass --allow-unknown-pkl)
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

KNOWN_MD5 = {
    "5a20ed46ea6494a9e969db2f6b97a88a": "karras2019stylegan-ffhq-1024x1024",
}


def md5_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def make_facenet_fixture(out: str, weights: str | None, test_num: int = 8
                         ) -> int:
    """Step 1 of the FaceNet runbook: run the GENUINE facenet_pytorch
    package (must be installed; this repo's code is not involved in the
    forward) on seeded inputs and persist a checksummed fixture."""
    try:
        import facenet_pytorch
    except ImportError:
        print("facenet_pytorch is not installed — run this step on a "
              "machine with it (see module docstring)", file=sys.stderr)
        return 3

    rng = np.random.default_rng(0)
    # The pipeline's FaceNet input contract: 160^2, Normalize(0.5, 0.5)
    # range — fixture inputs span [-1, 1].
    x = rng.uniform(-1.0, 1.0, (test_num, 3, 160, 160)).astype(np.float32)
    with torch.no_grad():
        if weights:
            model = facenet_pytorch.InceptionResnetV1().eval()
            model.load_state_dict(torch.load(weights, map_location="cpu"),
                                  strict=False)
        else:
            model = facenet_pytorch.InceptionResnetV1(
                pretrained="vggface2").eval()
        embs = model(torch.from_numpy(x)).numpy()
    meta = {
        "package_version": getattr(facenet_pytorch, "__version__", "?"),
        "weights_sha256": sha256_file(weights) if weights else "pretrained",
    }
    np.savez(out, inputs=x, embs=embs, **meta)
    print(json.dumps({"fixture": out, "embs_shape": list(embs.shape),
                      **meta}))
    return 0


def validate_facenet_fixture(weights: str, fixture: str, atol: float,
                             device="cuda") -> int:
    """Step 2: the port's FaceNet must reproduce the external fixture."""
    from ..models import facenet
    from ..utils import weights as W
    from ..utils.device import f32_exact_math

    z = np.load(fixture)
    verdict = {"fixture": fixture, "weights": weights,
               "fixture_weights_sha256": str(z["weights_sha256"])}
    if str(z["weights_sha256"]) not in ("pretrained", sha256_file(weights)):
        verdict["status"] = "WEIGHTS_MISMATCH"
        print(json.dumps(verdict))
        return 2
    params = W.load_frm_params(weights, "facenet", device=device)
    f32_exact_math()
    with torch.inference_mode():
        got = facenet.apply(params, torch.as_tensor(
            z["inputs"], device=params["last_linear"]["weight"].device))
    got = got.float().cpu().numpy()
    max_abs = float(np.abs(got - z["embs"]).max())
    verdict.update(max_abs=max_abs, atol=atol,
                   status="OK" if max_abs <= atol else "PARITY_FAIL")
    print(json.dumps(verdict))
    return 0 if max_abs <= atol else 1


def _synthesize(model: str, sd, resolution: int, test_num: int, device):
    """The port's f32 images [test_num, 3, H, W] (numpy) of seeded codes
    from the converted state dict ``sd``, and those codes."""
    from ..utils.device import f32_exact_math, resolve_device

    dev = resolve_device(device)
    f32_exact_math()
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        if model.startswith("stylegan"):
            from ..models import stylegan as sg

            params = sg.convert_torch_state_dict(sd, resolution, device=dev)
            codes = rng.standard_normal(
                (test_num, sg.num_layers(resolution), 512)).astype(np.float32)
            got = sg.synthesis_apply(params, torch.as_tensor(codes,
                                                             device=dev),
                                     resolution=resolution)
        else:
            from ..models import pggan as pg

            params = pg.convert_torch_state_dict(sd, resolution, device=dev)
            z = rng.standard_normal((test_num, 512)).astype(np.float32)
            codes = pg.preprocess_z(torch.as_tensor(z)).numpy()
            got = pg.apply(params, torch.as_tensor(codes, device=dev),
                           resolution=resolution)
    return got.float().cpu().numpy(), codes


def _reference_images(model: str, sd, resolution: int, codes, ref_dir: str):
    """The reference repo's torch generator built from ``sd``, on the
    CPU, applied to ``codes`` (W+ codes or normalised z)."""
    if ref_dir not in sys.path:
        sys.path.insert(0, ref_dir)
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    with torch.no_grad():
        if model.startswith("stylegan"):
            from models.stylegan_generator_model import (
                StyleGANGeneratorModel)

            net = StyleGANGeneratorModel(
                resolution=resolution, fused_scale="auto",
                truncation_psi=0.7, truncation_layers=8,
                randomize_noise=False).eval()
            net.load_state_dict(state, strict=False)
            return net.synthesis(torch.from_numpy(codes)).numpy()
        from models.pggan_generator_model import PGGANGeneratorModel

        # fused_scale=False per the reference registry
        net = PGGANGeneratorModel(resolution=resolution,
                                  fused_scale=False).eval()
        net.load_state_dict(state, strict=False)
        return net(torch.from_numpy(codes)).numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pkl", default=None)
    p.add_argument("--facenet-weights", default=None,
                   help="FaceNet runbook: real facenet_pytorch state dict")
    p.add_argument("--fixture", default=None,
                   help="FaceNet runbook step 2: checksummed fixture .npz")
    p.add_argument("--make-facenet-fixture", default=None, metavar="OUT",
                   help="FaceNet runbook step 1 (requires the genuine "
                        "facenet_pytorch package)")
    p.add_argument("--model", default="stylegan_ffhq",
                   choices=["stylegan_ffhq", "stylegan_celebahq",
                            "pggan_celebahq"])
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--test-num", type=int, default=4,
                   help="latents compared (the reference's self-test uses "
                        "10)")
    p.add_argument("--reference", default=None,
                   help="reference repo for the torch-side comparison; "
                        "skipped when not given")
    p.add_argument("--out", default=None,
                   help="save the converted state dict (.npz)")
    p.add_argument("--allow-unknown-pkl", action="store_true")
    p.add_argument("--atol", type=float, default=5e-4,
                   help="max abs output diff tolerance (f32 forward; the "
                        "reference logs ~1e-5 distances for its own "
                        "TF->torch conversion)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="device of the port's forward (cuda needs a CUDA "
                        "GPU)")
    args = p.parse_args(argv)

    if args.make_facenet_fixture:
        return make_facenet_fixture(args.make_facenet_fixture,
                                    args.facenet_weights, args.test_num)
    if args.fixture:
        if not args.facenet_weights:
            p.error("--fixture requires --facenet-weights")
        return validate_facenet_fixture(args.facenet_weights, args.fixture,
                                        args.atol, args.device)
    if not args.pkl:
        p.error("--pkl is required (or use the FaceNet runbook flags)")
    if args.reference is not None and not os.path.isdir(args.reference):
        p.error(f"--reference {args.reference} is not a directory")

    verdict = {"pkl": args.pkl, "model": args.model}

    digest = md5_file(args.pkl)
    verdict["md5"] = digest
    verdict["known_snapshot"] = KNOWN_MD5.get(digest)
    if digest not in KNOWN_MD5 and not args.allow_unknown_pkl:
        verdict["status"] = "UNKNOWN_PKL"
        print(json.dumps(verdict))
        print("md5 not in the documented snapshot table; re-run with "
              "--allow-unknown-pkl to validate anyway", file=sys.stderr)
        return 2

    from . import pkl_converter as PC

    tf_vars = PC.load_pkl_variables(args.pkl)
    if args.model.startswith("stylegan"):
        sd = PC.tf_vars_to_torch_state_dict(tf_vars, args.resolution)
    else:
        sd = PC.pggan_tf_vars_to_torch_state_dict(tf_vars, args.resolution)
    verdict["converted_leaves"] = len(sd)
    if args.out:
        np.savez(args.out, **{k: np.asarray(v) for k, v in sd.items()})
        verdict["out"] = args.out

    got, codes = _synthesize(args.model, sd, args.resolution, args.test_num,
                             args.device)
    verdict["output_shape"] = list(got.shape)
    verdict["output_std"] = float(np.std(got))

    if args.reference is not None:
        ref = _reference_images(args.model, sd, args.resolution, codes,
                                args.reference)
        scale = max(1.0, float(np.abs(ref).max()))
        max_abs = float(np.abs(got - ref).max() / scale)
        mean_abs = float(np.abs(got - ref).mean() / scale)
        verdict["torch_parity"] = {"max_abs": max_abs, "mean_abs": mean_abs,
                                   "atol": args.atol}
        verdict["status"] = "OK" if max_abs <= args.atol else "PARITY_FAIL"
    else:
        verdict["torch_parity"] = None
        verdict["status"] = "OK_NO_TORCH_ORACLE"

    print(json.dumps(verdict))
    return 0 if verdict["status"].startswith("OK") else 1


if __name__ == "__main__":
    raise SystemExit(main())
