"""Dual-handler logger (stdout INFO + file DEBUG), after
certifyingfacerecognition_tpu/utils/logger.py.

API mirror of the reference's utils/logger.py:11-66, including its refusal
to reuse logger names or clobber existing log files (the reference's
"fresh output dir per run" discipline, logger.py:37-58).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logger(work_dir: Optional[str] = None,
                 logfile_name: str = "log.txt", logger_name: str = "logger",
                 allow_existing: bool = False) -> logging.Logger:
    """A logger writing INFO to stdout and DEBUG to work_dir/logfile_name.
    allow_existing=True appends to an existing log file and returns a
    logger of that name that is already set up as it is. With work_dir
    None it writes to stdout only (a rank that writes no files)."""
    logger = logging.getLogger(logger_name)
    # Check the logger's OWN handlers, not hasHandlers(): that walks up to
    # the root logger and would trip on unrelated root handlers (pytest's
    # capture handler, absl, ...).
    if logger.handlers and not allow_existing:
        raise SystemExit(f"Logger name `{logger_name}` has already been set up!")
    if logger.handlers:
        return logger

    logger.setLevel(logging.DEBUG)
    formatter = logging.Formatter(
        "[%(asctime)s][%(levelname)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")

    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setLevel(logging.INFO)
    sh.setFormatter(formatter)
    logger.addHandler(sh)
    if work_dir is None:
        return logger

    os.makedirs(work_dir, exist_ok=True)
    log_path = os.path.join(work_dir, logfile_name)
    if os.path.isfile(log_path) and not allow_existing:
        raise SystemExit(f"Log file `{log_path}` already exists!")
    fh = logging.FileHandler(log_path)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(formatter)
    logger.addHandler(fh)
    return logger


def close_logger(logger: logging.Logger) -> None:
    """Close and detach the handlers of a setup_logger logger, so that the
    name can be set up again (another run in the same process)."""
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


def print_to_log(text: str, txt_file_path: str) -> None:
    """Append a line to a results text file (gen_utils.py:58-60)."""
    with open(txt_file_path, "a") as f:
        print(text, file=f)


def args2text(args) -> str:
    d = vars(args)
    return " | ".join(f"{k}: {d[k]}" for k in d)
