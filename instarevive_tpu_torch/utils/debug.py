"""Numerical-stability checks and a timer (``instarevive_tpu/utils/debug.py``).

* ``tree_finite_check`` / ``first_nonfinite_paths``: a per-tensor inf/nan
  audit of a name -> tensor mapping (a state dict, named gradients);
* ``all_finite``: one 0-dim bool tensor, computed on the tensors' device;
* ``nan_guard``: applies a gradient step only when every gradient is finite;
* ``SimpleTimer``: progress and ETA lines.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Mapping, Optional

import torch


def tree_finite_check(tree: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """{name: all finite} for every tensor."""
    return {name: bool(torch.isfinite(t).all()) for name, t in tree.items()}


def first_nonfinite_paths(tree: Mapping[str, torch.Tensor], limit: int = 10) -> List[str]:
    return [k for k, ok in tree_finite_check(tree).items() if not ok][:limit]


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor; no host synchronisation."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def nan_guard(state, grads, metrics: Optional[dict] = None) -> bool:
    """``state.apply_gradients(grads)`` unless a gradient is not finite, in
    which case the whole state (step and EMA included) stays as it was.
    Reads one flag from the device. Returns whether the step was applied."""
    ok = all_finite(grads)
    if metrics is not None:
        metrics["grads_finite"] = ok.float()
    applied = bool(ok)
    if applied:
        state.apply_gradients(grads)
    return applied


class SimpleTimer:
    """ETA logger."""

    def __init__(self, total: int, log_interval: int = 1, desc: str = "", initial: int = 0):
        self.total = total
        self.log_interval = log_interval
        self.desc = desc
        self.start = time.time()
        self.initial = initial  # resumed runs: display absolute step
        self.count = initial

    def update(self, n: int = 1) -> Optional[str]:
        self.count += n
        if self.count % self.log_interval:
            return None
        elapsed = time.time() - self.start
        rate = (self.count - self.initial) / max(elapsed, 1e-9)
        eta = (self.total - self.count) / max(rate, 1e-9)
        return (
            f"{self.desc}[{self.count}/{self.total}] "
            f"{rate:.2f} it/s, elapsed {elapsed:.0f}s, ETA {eta:.0f}s"
        )
