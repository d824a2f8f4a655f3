"""Tracing and timing (``instarevive_tpu/utils/profiling.py``).

* ``trace(log_dir)``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA activity, written as a Chrome trace ``log_dir/trace.json``
  (open it in ``chrome://tracing`` or Perfetto);
* ``time_fn``: the median wall time of a call, waiting for the card where
  the output is on it (``tools/time_restore.wall``);
* ``pipeline_stage_times``: that time for each stage of the restoration
  pipeline alone and for the whole call, under the JAX package's stage
  names. ``tools/time_restore.stage_ms`` splits one call by CUDA events
  instead.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterator

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the body and write ``log_dir/trace.json``; yields that path.
    The card is synchronised on entry and before the profiler stops, so the
    trace holds the body's work and only it."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    _sync()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(path)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls after ``warmup``,
    each ending in a synchronise when the card is in use."""
    from instarevive_tpu_torch.tools.time_restore import wall

    wall(lambda: fn(*args), warmup)
    return sorted(wall(lambda: fn(*args), iters))[iters // 2]


@torch.no_grad()
def pipeline_stage_times(pipe, lq: torch.Tensor, y: torch.Tensor, iters: int = 5) -> Dict[str, float]:
    """Seconds of each stage of ``pipe`` (a ``RestorationPipeline``) alone on
    ``lq`` (B, H, W, 3) and ``y``, and of ``process`` as a whole."""
    stage1 = pipe.clean(lq)
    z = pipe.encode(stage1)
    return {
        "swinir": time_fn(pipe.clean, lq, iters=iters),
        "vae_encode": time_fn(pipe.encode, stage1, iters=iters),
        "dit_one_step": time_fn(pipe.one_step, z, y, iters=iters),
        "vae_decode": time_fn(pipe.decode, z, iters=iters),
        "full_pipeline": time_fn(pipe.process, lq, y, iters=iters),
    }
