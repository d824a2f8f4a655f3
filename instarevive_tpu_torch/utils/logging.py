"""Logging scaffold (``instarevive_tpu/utils/logging.py``): a file + stream
logger with stale-log renaming, windowed metric averaging, and a tensorboard
writer that is a no-op where no tensorboard package is installed."""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np


def get_root_logger(
    log_file: Optional[str] = None, level: int = logging.INFO, name: str = "instarevive"
) -> logging.Logger:
    """One process, one logger: a stream handler and, with ``log_file``, a
    file handler; an existing log file is renamed with a timestamp first."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        if os.path.exists(log_file):
            ts = time.strftime("%Y%m%d_%H%M%S")
            os.rename(log_file, f"{log_file}.{ts}")
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(level)
    logger.propagate = False
    return logger


def close_logger(name: str = "instarevive") -> None:
    """Close and drop the logger's handlers, so that a second run in the same
    process opens its own log file."""
    logger = logging.getLogger(name)
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


class LogBuffer:
    """Windowed metric averaging (mmcv LogBuffer semantics)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._vals: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self._vals[k].append(float(v))

    def average(self) -> Dict[str, float]:
        return {k: float(np.mean(v)) for k, v in self._vals.items() if len(v)}

    def clear(self):
        self._vals.clear()


def _summary_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # no tensorboard package: the writer is a no-op
        return None
    return SummaryWriter(log_dir)


class MetricWriter:
    """Tensorboard scalars and image panels; a no-op without tensorboard."""

    def __init__(self, log_dir: str):
        self._dir, self._opened, self._writer = log_dir, False, None

    @property
    def _w(self):
        if not self._opened:  # at the first write: the import is slow where tensorboard pulls in tensorflow
            self._opened, self._writer = True, _summary_writer(self._dir)
        return self._writer

    def scalars(self, step: int, metrics: Dict[str, float]):
        if self._w is None:
            return
        for k, v in metrics.items():
            self._w.add_scalar(k, float(v), step)

    def images(self, step: int, tag: str, imgs01: np.ndarray):
        """NHWC [0,1] panel."""
        if self._w is None:
            return
        self._w.add_images(tag, np.clip(imgs01[:4], 0, 1), step, dataformats="NHWC")

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


def log_images_panel(lq: np.ndarray, pred: np.ndarray, hq: Optional[np.ndarray] = None):
    """Horizontal lq|pred|hq concat of NHWC batches."""
    parts = [lq, pred] + ([hq] if hq is not None else [])
    return np.concatenate(parts, axis=2)
