"""Timestep respacing (``instarevive_tpu/diffusion/respace.py``).

``space_timesteps`` picks a subset of the original T steps ('ddimN' or
section-count strings); ``respaced_schedule`` rebuilds a DiffusionSchedule
over the subset, whose ``timestep_map`` gives the model the original step of
each respaced index.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Set, Union

import numpy as np
import torch

from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule, make_schedule, named_betas


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """ADM-convention subset selection ('ddimN', 'N' or [n1, n2, ...])."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start = 0
    out = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            out.append(start + round(cur))
            cur += stride
        start += size
    return set(out)


def respaced_schedule(
    base_name: str = "linear",
    num_timesteps: int = 1000,
    use_timesteps: Union[str, Iterable[int], None] = None,
    **kw,
) -> DiffusionSchedule:
    """Schedule over a timestep subset, with betas recomputed in float64 so
    that the cumulative alphas match the original at the kept steps."""
    if use_timesteps is None:
        return make_schedule(base_name, num_timesteps, **kw)
    if isinstance(use_timesteps, str):
        use_timesteps = space_timesteps(num_timesteps, use_timesteps)
    kept = sorted(set(int(t) for t in use_timesteps))

    acp = np.cumprod(1.0 - named_betas(base_name, num_timesteps, **kw))
    last = 1.0
    new_betas = []
    for t in kept:
        new_betas.append(1.0 - acp[t] / last)
        last = acp[t]
    sched = make_schedule(betas=np.asarray(new_betas))
    return sched._replace(timestep_map=torch.tensor(kept, dtype=torch.int64, device="cpu"))
