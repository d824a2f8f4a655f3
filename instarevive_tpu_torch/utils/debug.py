"""Numerical-stability checks and a timer (``instarevive_tpu/utils/debug.py``).

* ``tree_finite_check`` / ``first_nonfinite_paths``: a per-tensor inf/nan
  audit of a name -> tensor mapping (a state dict, named gradients);
* ``all_finite``: one 0-dim bool tensor, computed on the tensors' device by
  one fused check;
* ``nan_guard``: applies a gradient step only where every gradient is finite,
  selecting on the device (no flag is read on the host);
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
    """0-dim bool tensor on the tensors' device: every element is finite.
    One fused check, not one reduction per tensor: the 2-norms of all the
    tensors by ``torch._foreach_norm`` (multi-tensor launches), stacked, and
    one ``isfinite`` of them. A NaN or an inf anywhere makes its tensor's norm
    non-finite; a finite tensor whose norm overflows f32 (elements near 1e19)
    counts as not finite too. Nothing is read on the host."""
    norms = torch._foreach_norm(list(tensors))
    return torch.isfinite(torch.stack(norms)).all()


def nan_guard(state, grads, metrics: Optional[dict] = None) -> torch.Tensor:
    """``state.apply_gradients(grads)`` where every gradient is finite, and
    the state (parameters, optimizer moments, step and EMA) bit for bit as it
    was where one is not: the JAX package's ``jnp.where(ok, new, old)`` over
    the whole state. The flag never leaves the device: the gradients are
    zeroed where it is down (one ``torch.where`` each, so no NaN reaches an
    update) and the update is gated by it on the device (``apply_gradients``
    with ``ok``). ``metrics['grads_finite']`` is the flag as an f32 0-dim
    tensor, read by the caller when it reads the step's other metrics.
    Returns the flag, a 0-dim bool tensor."""
    ok = all_finite(grads)
    if metrics is not None:
        metrics["grads_finite"] = ok.float()
    state.apply_gradients([torch.where(ok, g, 0.0) for g in grads], ok=ok)
    return ok


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
