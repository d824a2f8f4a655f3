"""Noise schedules (``instarevive_tpu/diffusion/schedules.py``).

The named beta schedules (ADM 'linear', 'squaredcos_cap_v2', the LDM's
'ldm_linear'), their cumulative alphas, the square-root coefficients, the
posterior of q(x_{t-1} | x_t, x_0) and the respacing table, computed in float64
numpy and stored as float32 tensors (``timestep_map`` as int64) on the host,
whatever device is the default: the samplers read them there, and
``extract`` copies each table to a device once.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


def named_betas(name: str, num_timesteps: int = 1000, **kw) -> np.ndarray:
    """Beta schedule by name:

    'linear'            ADM convention, scaled by 1000/T (``beta_start``, ``beta_end``)
    'squaredcos_cap_v2' cosine (alpha_bar = cos^2), each beta capped at 0.999
    'ldm_linear'        LDM: linspace on sqrt(beta) (``linear_start``, ``linear_end``)
    """
    if name == "linear":
        scale = 1000.0 / num_timesteps
        start = kw.get("beta_start", 0.0001) * scale
        end = kw.get("beta_end", 0.02) * scale
        return np.linspace(start, end, num_timesteps, dtype=np.float64)
    if name == "squaredcos_cap_v2":
        def abar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.asarray([min(1 - abar((i + 1) / num_timesteps) / abar(i / num_timesteps), 0.999)
                           for i in range(num_timesteps)], dtype=np.float64)
    if name == "ldm_linear":
        start = kw.get("linear_start", 0.00085)
        end = kw.get("linear_end", 0.012)
        return np.linspace(start**0.5, end**0.5, num_timesteps, dtype=np.float64) ** 2
    raise ValueError(f"unknown schedule {name!r}")


class DiffusionSchedule(NamedTuple):
    """All derived quantities of a discrete-time Gaussian diffusion."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    # the original-schedule timestep each index stands for (respacing); identity here
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(name: str = "linear", num_timesteps: int = 1000, betas: Optional[np.ndarray] = None,
                  **kw) -> DiffusionSchedule:
    """The schedule of the named betas, or of ``betas`` when given."""
    if betas is None:
        betas = named_betas(name, num_timesteps, **kw)
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cpu")  # noqa: E731
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.append(post_var[1], post_var[1:]))),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        log_betas=f32(np.log(betas)),
        timestep_map=torch.arange(len(betas), dtype=torch.int64, device="cpu"),
    )


def host_to(arr: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``; from the host to a card through pinned memory,
    without the host waiting for the card (a sampling loop's tables are
    moved inside it)."""
    if arr.device.type == "cpu" and torch.device(device).type == "cuda":
        return arr.pin_memory().to(device, non_blocking=True)
    return arr.to(device)


_moved = {}


def _on(arr: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``, copied there once per table and device."""
    if arr.device == device:
        return arr
    key = (id(arr), device)
    hit = _moved.get(key)
    if hit is None or hit[0] is not arr:
        hit = _moved[key] = (arr, host_to(arr, device))
    return hit[1]


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients and broadcast to an ndim tensor."""
    out = _on(arr, t.device)[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))
