"""Logging (a copy of `get_logger` from `slam_tpu/utils/logging.py`): the
rxi/log.c layout of level, time and file:line on stderr."""

from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s %(levelname)-5s %(filename)s:%(lineno)d: %(message)s"
_DATEFMT = "%H:%M:%S"


def get_logger(name: str = "slam_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger
