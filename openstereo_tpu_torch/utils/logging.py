"""Logging (the port's copy of `openstereo_tpu/utils/logging.py:16`): one
stream to stdout and, on process 0, to a file."""

from __future__ import annotations

import logging
import sys
from typing import Optional


def create_logger(log_file: Optional[str] = None, *, process_index: int = 0,
                  name: str = "openstereo_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.propagate = False
    level = logging.INFO if process_index == 0 else logging.WARNING
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    sh.setLevel(level)
    logger.addHandler(sh)
    if log_file is not None and process_index == 0:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        fh.setLevel(level)
        logger.addHandler(fh)
    return logger
