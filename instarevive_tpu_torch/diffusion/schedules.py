"""Noise schedules (``instarevive_tpu/diffusion/schedules.py``).

The ADM 'linear' beta schedule, its cumulative alphas and the square-root
coefficients that ``diffusion/gaussian.py`` reads, computed in float64 numpy
and stored as float32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def named_betas(name: str, num_timesteps: int = 1000) -> np.ndarray:
    """'linear': the ADM convention, scaled by 1000/T."""
    if name != "linear":
        raise NotImplementedError(f"schedule {name!r} is not ported yet")
    scale = 1000.0 / num_timesteps
    return np.linspace(0.0001 * scale, 0.02 * scale, num_timesteps, dtype=np.float64)


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(name: str = "linear", num_timesteps: int = 1000) -> DiffusionSchedule:
    betas = named_betas(name, num_timesteps)
    acp = np.cumprod(1.0 - betas)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
    )


_moved = {}


def _on(arr: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``, copied there once per table and device."""
    if arr.device == device:
        return arr
    key = (id(arr), device)
    hit = _moved.get(key)
    if hit is None or hit[0] is not arr:
        hit = _moved[key] = (arr, arr.to(device))
    return hit[1]


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients and broadcast to an ndim tensor."""
    out = _on(arr, t.device)[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))
