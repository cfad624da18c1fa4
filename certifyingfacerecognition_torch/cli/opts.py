"""Attack CLI flags (port of certifyingfacerecognition_tpu/cli/opts.py):
the same flags and defaults, plus --device. Flags of parts this port does
not have yet exit with a message that names the ROADMAP item porting them
(cli/main_attack.py)."""

from __future__ import annotations

import argparse
import os
import os.path as osp

from ..constants import ATTACKS, ATTRS, FRS_METHODS, LOSS_TYPES, OPTIMS
from ..utils.logger import args2text, print_to_log, setup_logger


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute semantic adversaries (PyTorch/CUDA)")
    parser.add_argument("--lr", type=float, default=1e2, help="Learning rate")
    parser.add_argument("--momentum", type=float, default=0.9,
                        help="Momentum for SGD")
    parser.add_argument("--loss", type=str, default="xent", choices=LOSS_TYPES,
                        help="Loss to optimize")
    parser.add_argument("--optim", type=str, default="SGD", choices=OPTIMS,
                        help="Optimizer to use")
    parser.add_argument("--no-lin-comb", action="store_true", default=False,
                        help="Compute adv NOT as lin. comb. of directions")
    parser.add_argument("--attack-type", type=str, default="manual",
                        choices=ATTACKS,
                        help="Attack to perform (only 'manual' is ported)")
    parser.add_argument("--iters", type=int, default=10,
                        help="Optimization iterations per instance")
    parser.add_argument("--restarts", type=int, default=10,
                        help="Random restarts per instance")
    parser.add_argument("--n-target-classes", type=int, default=10,
                        help="num of classes for targetted attacks "
                             "(not ported yet)")
    parser.add_argument("--attrs2drop", nargs="+", default=[],
                        choices=list(ATTRS.keys()),
                        help="List of attributes to NOT consider for attacks")
    parser.add_argument("--scale-factor", type=float, default=1.0,
                        help="Factor for scaling Sigma")
    parser.add_argument("--not-on-surf", action="store_true", default=False,
                        help="Random initialization is NOT on region surface")
    parser.add_argument("--output-dir", type=str, required=True,
                        help="Directory to save the output results (required)")
    parser.add_argument("--face-recog-method", type=str, default="insightface",
                        choices=FRS_METHODS,
                        help="Face recognition system to use")
    parser.add_argument("--chunks", type=int, default=50_000,
                        help="num of chunks in which to break the dataset")
    parser.add_argument("--num-chunk", type=int, default=None,
                        help="index of chunk to evaluate on")
    parser.add_argument("--eval-files", action="store_true", default=False,
                        help="evaluate based on files at "
                             "exp_results/logs/results_chunk*of*.txt")
    parser.add_argument("--load-embs", action="store_true", default=False,
                        help="Whether to load embs from file")
    parser.add_argument("--load-n-embs", type=int, default=1_000_000,
                        help="num of embs. Default is all of them (1M)")
    parser.add_argument("--embs-file", type=str, default=None,
                        help="Load embs from this file")
    parser.add_argument("--seed", type=int, default=0,
                        help="for deterministic behavior")
    parser.add_argument("--gen-weights", type=str, default="random",
                        help=".npz/.pth StyleGAN weights, or 'random[:seed]'")
    parser.add_argument("--frm-weights", type=str, default="random",
                        help=".npz/.pth FRM weights, or 'random[:seed]'")
    parser.add_argument("--data-dir", type=str,
                        default=os.environ.get("CFR_DATA_DIR",
                                               "data/stylegan_ffhq_1M"),
                        help="Directory with w.npy latent codes")
    parser.add_argument("--boundaries-dir", type=str, default=None,
                        help="InterFaceGAN boundary .npy directory")
    parser.add_argument("--batch-size", type=int, default=48,
                        help="Identities per attack step")
    parser.add_argument("--resolution", type=int, default=1024,
                        help="StyleGAN synthesis resolution")
    parser.add_argument("--synthesis-resolution", type=int, default=None,
                        help="Truncate synthesis at this resolution while "
                             "loading --resolution weights (the FRM sees a "
                             "112^2 resize either way). Attack "
                             "success/magnitudes then refer to the "
                             "truncated pipeline; cached embeddings get "
                             "their own default name, "
                             "embs_<method>_sr<res>.npz")
    parser.add_argument("--dtype", type=str, default="fp32",
                        choices=["fp32", "bf16"],
                        help="Compute dtype of the pipeline")
    parser.add_argument("--mesh", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument("--autoattack-iters", type=int, default=100,
                        help="not ported yet")
    parser.add_argument("--square-queries", type=int, default=5000,
                        help="not ported yet")
    parser.add_argument("--apgd-use-cli-iters", action="store_true",
                        default=False, help="not ported yet")
    parser.add_argument("--run-checks", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument("--coordinator-address", type=str, default=None,
                        help="not ported yet")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="not ported yet")
    parser.add_argument("--process-id", type=int, default=None,
                        help="not ported yet")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="not ported yet")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (cuda needs a CUDA GPU)")
    return parser


def finalize_args(args: argparse.Namespace) -> argparse.Namespace:
    """Derived dirs and logger: exp_results/<out>/{results,logs,figs}."""
    args.output_dir = osp.join("exp_results", args.output_dir)
    args.lin_comb = not args.no_lin_comb

    args.results_dir = osp.join(args.output_dir, "results")
    args.logs_dir = osp.join(args.output_dir, "logs")
    args.figs_dir = osp.join(args.output_dir, "figs")
    for d in (args.output_dir, args.results_dir, args.logs_dir,
              args.figs_dir):
        os.makedirs(d, exist_ok=True)

    chunk = "all" if args.num_chunk is None else args.num_chunk
    args.info_log = osp.join(args.output_dir, f"info_chunk_{chunk}.txt")
    print_to_log(args2text(args), args.info_log)

    args.final_results = osp.join(args.output_dir, "results.txt")

    # Logger names are process-global: qualify by output dir so different
    # experiments can run from one process.
    logger = setup_logger(
        osp.join(args.output_dir, f"chunk_{chunk}"),
        logger_name=f"{osp.basename(args.output_dir)}_chunk_{chunk}")
    logger.info(args2text(args))
    args.LOGGER = logger
    return args
