"""Console + file logging (the port's copy of
speech2text_tpu/utils/logging.py): glog-style lines on stderr and, for a
training run, in `run.log` of the task's export directory."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(levelname).1s %(asctime)s %(filename)s:%(lineno)d] %(message)s"
_DATEFMT = "%m%d %H:%M:%S"


def init_logging(log_file: str | None = None, level: int = logging.INFO) -> logging.Logger:
    """Configure the root logger with console + optional file handlers."""
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    fmt = logging.Formatter(_FMT, datefmt=_DATEFMT)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


def get_logger(name: str = "speech2text_torch") -> logging.Logger:
    return logging.getLogger(name)
