"""Experiment logging: file and console handlers, main-process gating.

Counterpart of ``vision_collision_detection_tpu/obs/logging_utils.py``. The
main process is rank 0 of the ``torch.distributed`` process group when one
is initialised, and the only process otherwise.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

import torch.distributed as dist


def process_rank() -> int:
    """This process's rank in the initialised process group, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return process_rank() == 0


def setup_logging(run_dir: Optional[str] = None, name: str = "vcd",
                  level: int = logging.INFO,
                  main_only: bool = True) -> logging.Logger:
    """The ``name`` logger with its handlers replaced: the console, and
    ``<run_dir>/training.log`` where a run directory is given; a
    ``NullHandler`` on every process but the main one when ``main_only``."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.propagate = False

    if main_only and not is_main_process():
        logger.addHandler(logging.NullHandler())
        return logger

    fmt = logging.Formatter(
        "%(asctime)s [proc %(process)d] %(levelname)s %(message)s",
        datefmt="%H:%M:%S",
    )
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(fmt)
    logger.addHandler(console)
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(run_dir, "training.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
