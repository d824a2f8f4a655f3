"""LatentDiffusion task variants (``instarevive_tpu/train/ldm_tasks.py``):
the base latent-diffusion loss (eps, v or x0 prediction) and its inpaint,
upscale and depth-to-image forms, whose conditioning is concatenated to the
noisy latent (a UNet with ``in_channels`` widened: inpaint 4 + 4 + 1 = 9,
upscale 4 + 4 = 8, depth 4 + 1 = 5).

The VAE is frozen: ``encode`` runs under ``torch.no_grad()``. The depth
source is pluggable: precomputed maps in ``batch['depth']`` or a
``depth_fn(hq) -> (B, H, W, 1)``. Draws (t, noise) come from an explicit
``torch.Generator`` or are handed in.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from instarevive_tpu_torch.diffusion.gaussian import q_sample
from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule, extract
from instarevive_tpu_torch.ops.resize import interpolate
from instarevive_tpu_torch.train.distill import draw_noise, draw_timesteps

SCALE_FACTOR = 0.18215


class LatentDiffusionTask:
    """Latent-space diffusion training of ``unet`` on the frozen ``vae``'s
    scaled latents. ``batch``: {'hq' in [-1, 1] NHWC, 'context' (B, L, D), ...}."""

    def __init__(self, unet, vae, sched: DiffusionSchedule, parameterization: str = "eps"):
        self.unet, self.vae, self.sched, self.parameterization = unet, vae, sched, parameterization

    @torch.no_grad()
    def encode(self, img: torch.Tensor) -> torch.Tensor:
        return self.vae.encode_mode(img).float() * SCALE_FACTOR

    def _target(self, z0, noise, t):
        if self.parameterization == "eps":
            return noise
        if self.parameterization == "x0":
            return z0
        # v: sqrt(abar) eps - sqrt(1 - abar) x0
        return (extract(self.sched.sqrt_alphas_cumprod, t, z0.ndim) * noise
                - extract(self.sched.sqrt_one_minus_alphas_cumprod, t, z0.ndim) * z0)

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             extra_cond: Optional[torch.Tensor] = None, *, t=None, noise=None):
        z0 = self.encode(batch["hq"])
        b = z0.shape[0]
        if t is None:
            t = draw_timesteps(generator, b, 0, self.sched.num_timesteps, z0.device)
        if noise is None:
            noise = draw_noise(generator, z0.shape, z0.device)
        z_t = q_sample(self.sched, z0, t, noise)
        unet_in = z_t if extra_cond is None else torch.cat([z_t, extra_cond], dim=-1)
        pred = self.unet(unet_in, t.float(), batch["context"]).float()
        loss = torch.mean((pred - self._target(z0, noise, t)) ** 2)
        return loss, {"loss_simple": loss.detach()}

    def inpaint_loss(self, batch, generator: Optional[torch.Generator] = None, **draws):
        """Concat-mode inpainting: the UNet sees [z_t, the masked image's
        latent, the mask at the latent size]. ``batch['mask']`` (B, H, W, 1),
        1 = hole."""
        mask = batch["mask"]
        masked_z = self.encode(batch["hq"] * (1.0 - mask))
        mask_lat = interpolate(mask, masked_z.shape[1:3], mode="nearest")
        return self.loss(batch, generator, extra_cond=torch.cat([masked_z, mask_lat], dim=-1), **draws)

    def upscale_loss(self, batch, generator: Optional[torch.Generator] = None, **draws):
        """Low-resolution conditioning: ``batch['lq']`` in [-1, 1] at any size,
        resized bicubically to ``hq``'s, encoded and concatenated."""
        lq = interpolate(batch["lq"], batch["hq"].shape[1:3], mode="bicubic")
        return self.loss(batch, generator, extra_cond=self.encode(lq), **draws)

    @staticmethod
    def depth_conditioning(depth: torch.Tensor, latent_hw) -> torch.Tensor:
        """A depth map resized bicubically to the latent grid, then min-max
        normalised per sample to [-1, 1] (denominator eps 0.001)."""
        cc = interpolate(depth, tuple(latent_hw), mode="bicubic")
        dmin = cc.amin(dim=(1, 2, 3), keepdim=True)
        dmax = cc.amax(dim=(1, 2, 3), keepdim=True)
        return 2.0 * (cc - dmin) / (dmax - dmin + 0.001) - 1.0

    def depth2image_loss(self, batch, generator: Optional[torch.Generator] = None,
                         depth_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None, **draws):
        """Depth-conditioned generation: the UNet sees [z_t, normalised depth]."""
        depth = depth_fn(batch["hq"]) if depth_fn is not None else batch["depth"]
        f = 2 ** (len(self.vae.ch_mult) - 1)
        latent_hw = (batch["hq"].shape[1] // f, batch["hq"].shape[2] // f)
        return self.loss(batch, generator, extra_cond=self.depth_conditioning(depth, latent_hw), **draws)
