"""Logging (a copy of `slam_tpu/utils/logging.py`): the rxi/log.c
equivalent (`slam/thirdparty/log.{h,cpp}`) on Python's logging: the layout
of level, time and file:line on stderr, the TRACE level below DEBUG, the
global level filter and file sinks."""

from __future__ import annotations

import logging
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

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


def set_level(level, name: str = "slam_tpu_torch") -> None:
    """`log_set_level` equivalent (`slam/thirdparty/log.cpp:114`)."""
    logging.getLogger(name).setLevel(level)


def add_file_sink(path: str, level=TRACE, name: str = "slam_tpu_torch") -> None:
    """`log_add_fp` equivalent (`slam/thirdparty/log.cpp:126-143`)."""
    h = logging.FileHandler(path)
    h.setLevel(level)
    h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    logging.getLogger(name).addHandler(h)


def trace(msg, *args, name: str = "slam_tpu_torch"):
    logging.getLogger(name).log(TRACE, msg, *args, stacklevel=2)
