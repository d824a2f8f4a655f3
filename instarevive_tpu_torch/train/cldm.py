"""ControlLDM-family training tasks (``instarevive_tpu/train/cldm.py``).

* ControlLDM: frozen SwinIR on ``lq`` and the frozen VAE give the control
  latent; the ControlNet's residuals go into the UNet; eps-prediction loss;
  the ControlNet trains, and the UNet's decoder unless ``sd_locked``.
* Reflow: velocity matching on the straight path z_t = t_hat z_T + (1 - t_hat) z0;
  the one-step sampler and the 5-step Euler sampler (999, 799, 599, 349, 199).
* Dist: a LoRA-adapted UNet at fixed t = T - 1, v ~ z0 - z_T.

Freezing is ``requires_grad``: the trainer turns it off on every parameter it
does not train before it builds the optimizer, so autograd never runs the
frozen UNet encoder's backward and the optimizer never touches a frozen
weight. (The JAX package freezes with ``optax.masked``, which hands the raw
gradient through as the update of every masked-out leaf, so there the
"frozen" UNet weights move by their gradient each step; the reference, and
the port, keep them fixed.)

Every random draw (t, noise, z_T) comes from an explicit ``torch.Generator``
or is handed in, so a test can give both packages the same numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

from instarevive_tpu_torch.diffusion.gaussian import q_sample
from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule
from instarevive_tpu_torch.models.unet import UNetBackbone
from instarevive_tpu_torch.train.distill import draw_noise, draw_timesteps
from instarevive_tpu_torch.train.lora import Lora, merge_lora

SCALE_FACTOR = 0.18215  # configs/cldm.yaml scale_factor

Latents = Tuple[torch.Tensor, torch.Tensor]


class ControlLDM(nn.Module):
    """The two trained models under one module, so that one ``TrainState``
    holds them (state-dict keys ``unet.*`` and ``controlnet.*``)."""

    def __init__(self, unet: UNetBackbone, controlnet: UNetBackbone):
        super().__init__()
        self.unet, self.controlnet = unet, controlnet


class ControlLDMTask:
    """The frozen input path, the controlled UNet and the objectives.
    ``batch``: {'hq' in [-1, 1] NHWC, 'lq' in [0, 1] NHWC, 'context' (B, L, D)}."""

    def __init__(self, unet: UNetBackbone, controlnet: UNetBackbone, vae, swinir, sched: DiffusionSchedule,
                 sd_locked: bool = False):
        self.unet, self.controlnet, self.vae, self.swinir = unet, controlnet, vae, swinir
        self.sched, self.sd_locked = sched, sd_locked

    @torch.no_grad()
    def get_input(self, batch: Dict[str, torch.Tensor]) -> Latents:
        """(z0, c_latent): the scaled VAE posterior mode of ``hq``, and of the
        SwinIR-cleaned ``lq`` clamped to [0, 1] and mapped to [-1, 1], in f32."""
        z0 = self.vae.encode_mode(batch["hq"]).float() * SCALE_FACTOR
        control = self.swinir(batch["lq"]).float().clamp(0.0, 1.0) * 2.0 - 1.0
        return z0, self.vae.encode_mode(control).float() * SCALE_FACTOR

    def apply_model(self, z_t: torch.Tensor, t: torch.Tensor, context: torch.Tensor, c_latent: torch.Tensor,
                    unet_params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The ControlNet over concat(z_t, c_latent), then the UNet with its
        residuals (with ``unet_params`` in place of the UNet's own); f32 out."""
        t = t.float()
        control = UNetBackbone.forward(self.controlnet, torch.cat([z_t, c_latent], dim=-1), t, context)
        if unet_params is None:
            return self.unet(z_t, t, context, control=control).float()
        return functional_call(self.unet, unet_params, (z_t, t, context), {"control": control}).float()

    def eps_loss(self, batch, generator: Optional[torch.Generator] = None, *, t=None, loss_weights=None,
                 noise=None, latents: Optional[Latents] = None):
        """Eps-prediction MSE, per sample weighted by ``loss_weights`` (an
        importance sampler's) and averaged. Returns (loss, metrics) with the
        per-sample losses and t for the sampler's update."""
        z0, c_latent = latents if latents is not None else self.get_input(batch)
        b = z0.shape[0]
        if t is None:
            t = draw_timesteps(generator, b, 0, self.sched.num_timesteps, z0.device)
        if noise is None:
            noise = draw_noise(generator, z0.shape, z0.device)
        eps = self.apply_model(q_sample(self.sched, z0, t, noise), t, batch["context"], c_latent)
        per_sample = torch.mean((eps - noise) ** 2, dim=(1, 2, 3))
        w = torch.ones_like(per_sample) if loss_weights is None else loss_weights
        loss = torch.mean(per_sample * w)
        return loss, {"loss_simple": loss.detach(), "t": t, "per_sample_loss": per_sample.detach()}

    def reflow_loss(self, batch, generator: Optional[torch.Generator] = None, *, t=None, z_T=None,
                    latents: Optional[Latents] = None):
        """Velocity matching: t ~ U[1, T), z_T ~ N(0, 1), target z0 - z_T."""
        z0, c_latent = latents if latents is not None else self.get_input(batch)
        b, T = z0.shape[0], self.sched.num_timesteps
        if t is None:
            t = draw_timesteps(generator, b, 1, T, z0.device)
        if z_T is None:
            z_T = draw_noise(generator, z0.shape, z0.device)
        t_hat = (t.float() / T).reshape(b, 1, 1, 1)
        v = self.apply_model(t_hat * z_T + (1.0 - t_hat) * z0, t, batch["context"], c_latent)
        loss = torch.mean((v - (z0 - z_T)) ** 2)
        return loss, {"reflow_mse": loss.detach()}

    def dist_loss(self, lora: Lora, batch, generator: Optional[torch.Generator] = None, *, z_T=None,
                  latents: Optional[Latents] = None):
        """LoRA distillation: the UNet with ``merge_lora`` applied, fixed
        t = T - 1, v ~ z0 - z_T. Differentiable in the adapters."""
        z0, c_latent = latents if latents is not None else self.get_input(batch)
        if z_T is None:
            z_T = draw_noise(generator, z0.shape, z0.device)
        t = torch.full((z0.shape[0],), self.sched.num_timesteps - 1, dtype=torch.int64, device=z0.device)
        merged = merge_lora(dict(self.unet.named_parameters()), lora)
        v = self.apply_model(z_T, t, batch["context"], c_latent, unet_params=merged)
        loss = torch.mean((v - (z0 - z_T)) ** 2)
        return loss, {"dist_mse": loss.detach()}

    @torch.no_grad()
    def reflow_sample_1step(self, batch, generator: Optional[torch.Generator] = None, z_T=None) -> torch.Tensor:
        _, c_latent = self.get_input(batch)
        if z_T is None:
            z_T = draw_noise(generator, c_latent.shape, c_latent.device)
        t = torch.full((z_T.shape[0],), self.sched.num_timesteps - 1, dtype=torch.int64, device=z_T.device)
        return z_T + self.apply_model(z_T, t, batch["context"], c_latent)

    @torch.no_grad()
    def reflow_sample_euler(self, batch, generator: Optional[torch.Generator] = None,
                            steps: Sequence[int] = (999, 799, 599, 349, 199), z=None) -> torch.Tensor:
        """The test-time Euler sampler: z <- z + v / len(steps) at each t of ``steps``."""
        _, c_latent = self.get_input(batch)
        if z is None:
            z = draw_noise(generator, c_latent.shape, c_latent.device)
        for s in steps:
            t = torch.full((z.shape[0],), s, dtype=torch.int64, device=z.device)
            z = z + self.apply_model(z, t, batch["context"], c_latent) / len(steps)
        return z
