"""Gaussian diffusion q/p math (``instarevive_tpu/diffusion/gaussian.py``):
the three closed forms the distillation losses read. The sampling loops and
``training_losses`` are not ported yet."""

from __future__ import annotations

import torch

from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule, extract


def q_sample(sched: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Diffuse x0 to x_t."""
    return (
        extract(sched.sqrt_alphas_cumprod, t, x0.ndim) * x0
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, x0.ndim) * noise
    )


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps
    )


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)
