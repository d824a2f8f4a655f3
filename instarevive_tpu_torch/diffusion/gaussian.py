"""Gaussian diffusion processes (``instarevive_tpu/diffusion/gaussian.py``):
the q/p math (eps, x0 or v prediction, the learned variance range), the
ancestral DDPM and the DDIM loops, and the MSE(+VB) training loss.

The loops are Python loops over the (possibly respaced) schedule, counting
down from T-1 to 0; ``model_fn(x, t)`` gets ``timestep_map[t]``, the original
step, as an int64 tensor on x's device, and every coefficient is gathered on
the device, so a step reads nothing back to the host. Draws come from an
explicit ``torch.Generator``, or are handed in (``noise``, ``step_noise``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule, _on, extract

ModelFn = Callable[..., torch.Tensor]  # (x, t) -> prediction


class PSample(NamedTuple):
    mean: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


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


def predict_xstart_from_v(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """LDM v-parameterization."""
    return (
        extract(sched.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
        - extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v
    )


def q_posterior_mean(sched: DiffusionSchedule, x0: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (
        extract(sched.posterior_mean_coef1, t, x_t.ndim) * x0
        + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t
    )


def p_mean_variance(sched: DiffusionSchedule, model_out: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor, *,
                    parameterization: str = "eps", learned_range: bool = True,
                    clip_denoised: bool = False) -> PSample:
    """Model output -> posterior mean, log-variance and x0 estimate. With
    ``learned_range`` the model emits 2C channels; the second half
    interpolates the log-variance between beta and the posterior's (ADM)."""
    if learned_range:
        c = x_t.shape[-1]
        model_out, var_raw = model_out[..., :c], model_out[..., c:]
        min_log = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
        max_log = extract(sched.log_betas, t, x_t.ndim)
        frac = (var_raw + 1.0) / 2.0
        log_variance = frac * max_log + (1.0 - frac) * min_log
    else:
        log_variance = extract(sched.posterior_log_variance_clipped, t, x_t.ndim).expand(x_t.shape)

    if parameterization == "eps":
        x0 = predict_xstart_from_eps(sched, x_t, t, model_out)
    elif parameterization == "x0":
        x0 = model_out
    elif parameterization == "v":
        x0 = predict_xstart_from_v(sched, x_t, t, model_out)
    else:
        raise ValueError(parameterization)
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    return PSample(q_posterior_mean(sched, x0, x_t, t), log_variance, x0)


def _start(shape, generator: Optional[torch.Generator], noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The initial x: ``noise``, or a draw from ``generator`` on its device."""
    if noise is not None:
        return noise
    return torch.randn(shape, generator=generator, device=None if generator is None else generator.device)


def _step_draw(i: int, x: torch.Tensor, generator: Optional[torch.Generator],
               step_noise: Optional[torch.Tensor]) -> torch.Tensor:
    return step_noise[i] if step_noise is not None else torch.randn(x.shape, generator=generator, device=x.device)


def ddpm_sample_loop(sched: DiffusionSchedule, model_fn: ModelFn, shape, generator: Optional[torch.Generator] = None,
                     *, noise: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
                     parameterization: str = "eps", learned_range: bool = True,
                     clip_denoised: bool = False) -> torch.Tensor:
    """Ancestral DDPM sampling. ``step_noise`` (num_timesteps, *shape) hands
    in the draw of each step in loop order (the last is not used: no noise
    at index 0)."""
    x = _start(shape, generator, noise)
    b = x.shape[0]
    tmap = _on(sched.timestep_map, x.device)
    for i, t_idx in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((b,), t_idx, dtype=torch.int64, device=x.device)
        ps = p_mean_variance(sched, model_fn(x, tmap[t]), x, t, parameterization=parameterization,
                             learned_range=learned_range, clip_denoised=clip_denoised)
        if t_idx > 0:
            x = ps.mean + torch.exp(0.5 * ps.log_variance) * _step_draw(i, x, generator, step_noise)
        else:
            x = ps.mean
    return x


def ddim_sample_loop(sched: DiffusionSchedule, model_fn: ModelFn, shape, generator: Optional[torch.Generator] = None,
                     *, noise: Optional[torch.Tensor] = None, step_noise: Optional[torch.Tensor] = None,
                     eta: float = 0.0, parameterization: str = "eps", learned_range: bool = True,
                     clip_denoised: bool = False) -> torch.Tensor:
    """DDIM sampling over the (possibly respaced) schedule; at ``eta`` 0 it
    draws nothing after the initial x."""
    x = _start(shape, generator, noise)
    b = x.shape[0]
    tmap = _on(sched.timestep_map, x.device)
    for i, t_idx in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((b,), t_idx, dtype=torch.int64, device=x.device)
        ps = p_mean_variance(sched, model_fn(x, tmap[t]), x, t, parameterization=parameterization,
                             learned_range=learned_range, clip_denoised=clip_denoised)
        eps = predict_eps_from_xstart(sched, x, t, ps.pred_xstart)
        abar = extract(sched.alphas_cumprod, t, x.ndim)
        abar_prev = extract(sched.alphas_cumprod_prev, t, x.ndim)
        sigma = eta * torch.sqrt((1 - abar_prev) / (1 - abar)) * torch.sqrt(1 - abar / abar_prev)
        x = torch.sqrt(abar_prev) * ps.pred_xstart + torch.sqrt(torch.clamp(1 - abar_prev - sigma**2, min=0.0)) * eps
        if t_idx > 0 and eta != 0.0:
            x = x + sigma * _step_draw(i, x, generator, step_noise)
    return x


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def _mean_flat(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over all but the batch axis; with ``mask`` (B, H, W), the mean
    over the pixels the mask keeps (masked-token loss)."""
    axes = tuple(range(1, x.ndim))
    if mask is None:
        return x.mean(axes)
    w = mask[..., None].to(x.dtype).expand(x.shape)
    return (x * w).sum(axes) / torch.clamp(w.sum(axes), min=1.0)


def training_losses(sched: DiffusionSchedule, model_fn: ModelFn, x0: torch.Tensor, t: torch.Tensor,
                    generator: Optional[torch.Generator] = None, *, noise: Optional[torch.Tensor] = None,
                    learned_range: bool = True, snr_switch_t: Optional[int] = None,
                    mask: Optional[torch.Tensor] = None):
    """MSE(+VB) diffusion loss. ``snr_switch_t``: the target is the noise for
    t > snr_switch_t and x0 below (the DMD recipe's switch). ``noise`` hands
    in the draw. Returns dict(loss, mse, vb)."""
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device)
    x_t = q_sample(sched, x0, t, noise)
    out = model_fn(x_t, _on(sched.timestep_map, t.device)[t])

    vb = 0.0
    if learned_range:
        c = x0.shape[-1]
        eps_pred, var_raw = out[..., :c], out[..., c:]
        # the VB term sees a frozen mean: its gradient reaches only the variance
        frozen = torch.cat([eps_pred.detach(), var_raw], dim=-1)
        ps = p_mean_variance(sched, frozen, x_t, t, learned_range=True)
        true_mean = q_posterior_mean(sched, x0, x_t, t)
        true_logvar = extract(sched.posterior_log_variance_clipped, t, x0.ndim)
        kl = _mean_flat(_normal_kl(true_mean, true_logvar, ps.mean, ps.log_variance), mask)
        vb = kl / math.log(2.0) * (sched.num_timesteps / 1000.0)
    else:
        eps_pred = out

    if snr_switch_t is not None:
        target = torch.where(t.reshape((-1,) + (1,) * (x0.ndim - 1)) > snr_switch_t, noise, x0)
    else:
        target = noise
    mse = _mean_flat((target - eps_pred) ** 2, mask)
    return {"loss": mse + vb, "mse": mse, "vb": vb}
