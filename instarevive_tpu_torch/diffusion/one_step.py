"""One-step generator math (``instarevive_tpu/diffusion/one_step.py``), and
the classifier-free guidance wrapper the many-step samplers call."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule, extract


def eps_to_x0(sched: DiffusionSchedule, eps: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x0 = (x_t - sqrt(1 - abar_t) eps) / sqrt(abar_t), in float32."""
    abar = extract(sched.alphas_cumprod, t, x_t.ndim)
    return (x_t.float() - torch.sqrt(1.0 - abar) * eps.float()) / torch.sqrt(abar)


def generate_sample_1step(model_fn: Callable[..., torch.Tensor], sched: DiffusionSchedule, latents: torch.Tensor,
                          maxt: int, *, split_sigma: bool = True, **cond) -> torch.Tensor:
    """Single-step denoise: the model's eps at t = maxt -> x0.
    ``model_fn(latents, t, **cond)`` returns eps (and the learned-sigma
    channels with ``split_sigma``)."""
    t = torch.full((latents.shape[0],), maxt, dtype=torch.int64, device=latents.device)
    out = model_fn(latents, t, **cond)
    if split_sigma:
        out = out[..., : latents.shape[-1]]
    return eps_to_x0(sched, out, latents, t)


def cfg_wrap(model_fn: Callable[..., torch.Tensor], cfg_scale: float, uncond: dict,
             split_channels: Optional[int] = 3) -> Callable[..., torch.Tensor]:
    """Classifier-free guidance: one model call on the conditional and the
    unconditional rows together; eps = u + cfg_scale (c - u), the other
    channels (the learned variance) from the conditional rows."""

    def wrapped(x, t, **cond):
        merged = {k: torch.cat([cond[k], uncond[k]]) for k in cond}
        out = model_fn(torch.cat([x, x]), torch.cat([t, t]), **merged)
        eps, rest = out[..., :split_channels], out[..., split_channels:]
        c_eps, u_eps = eps.chunk(2)
        half = u_eps + cfg_scale * (c_eps - u_eps)
        return torch.cat([torch.cat([half, half]), rest], dim=-1)[: x.shape[0]]

    return wrapped
