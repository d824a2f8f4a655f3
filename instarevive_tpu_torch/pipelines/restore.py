"""One-step blind restoration pipeline (``instarevive_tpu/pipelines/restore.py``).

SwinIR clean -> VAE encode (posterior mode x 0.18215) as the init latent ->
one DiT forward at t=400 -> eps to x0 -> VAE decode -> color fix -> clamp,
with a tiled mode that overlap-averages in latent space and again in pixel
space. Images and latents are NHWC. Stages run on the whole batch; tiles
are Python loops, with the DiT run on up to ``tile_batch`` tiles at once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from instarevive_tpu_torch.diffusion.one_step import eps_to_x0
from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule
from instarevive_tpu_torch.models.pixart import PixArt
from instarevive_tpu_torch.models.swinir import SwinIR
from instarevive_tpu_torch.models.vae import AutoencoderKL
from instarevive_tpu_torch.ops.color import adain_color_fix, wavelet_color_fix

VAE_SCALE = 0.18215


def sliding_offsets(length: int, tile: int, stride: int) -> np.ndarray:
    """Window offsets including a final end-aligned one."""
    offs = list(range(0, length - tile + 1, stride))
    if not offs or offs[-1] + tile < length:
        offs.append(length - tile)
    return np.asarray(offs, dtype=np.int64)


def tile_grid(h: int, w: int, tile: int, stride: int) -> np.ndarray:
    hs = sliding_offsets(h, tile, stride)
    ws = sliding_offsets(w, tile, stride)
    return np.stack(np.meshgrid(hs, ws, indexing="ij"), axis=-1).reshape(-1, 2)


def auto_tile_geometry(
    h: int,
    w: int,
    *,
    overlap: int = 64,
    candidates: Tuple[int, ...] = (512, 576, 640),
    latent_factor: int = 8,
) -> Tuple[int, int]:
    """(tile_size, tile_stride) minimizing total tile work, n_tiles * tile^2,
    for an (h, w) padded image, keeping a ``overlap`` px blend; the grid is
    counted in latent units exactly as ``process_tiled`` builds it."""
    f = latent_factor
    best = None
    for tile in candidates:
        if tile > min(h, w):
            continue
        stride = tile - overlap
        n = len(sliding_offsets(h // f, tile // f, stride // f)) * len(
            sliding_offsets(w // f, tile // f, stride // f)
        )
        cost = n * tile * tile
        if best is None or cost < best[0]:
            best = (cost, tile, stride)
    if best is None:  # image smaller than every candidate: one full tile
        tile = max(64, (min(h, w) // 64) * 64)
        return tile, max(64, tile - overlap)
    return best[1], best[2]


def _color_fix(img: torch.Tensor, ref: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "wavelet":
        return wavelet_color_fix(img, ref)
    if kind == "adain":
        return adain_color_fix(img, ref)
    if kind == "none":
        return img
    raise ValueError(f"unknown color fix {kind!r}")


class RestorationPipeline(nn.Module):
    """The three models and the schedule; ``process`` / ``process_tiled``
    are the entry points. Runs under ``torch.inference_mode``."""

    def __init__(self, swinir: SwinIR, vae: AutoencoderKL, dit: PixArt,
                 sched: DiffusionSchedule, maxt: int = 400, control_depth: int = 0):
        super().__init__()
        self.swinir, self.vae, self.dit = swinir, vae, dit
        self.sched, self.maxt, self.control_depth = sched, maxt, control_depth

    @property
    def latent_factor(self) -> int:
        return 2 ** (len(self.vae.ch_mult) - 1)

    def clean(self, img: torch.Tensor) -> torch.Tensor:
        """SwinIR stage 1; not clamped (encode and color fix read it raw)."""
        return self.swinir(img)

    def encode(self, img01: torch.Tensor) -> torch.Tensor:
        return self.vae.encode_mode(img01 * 2.0 - 1.0) * VAE_SCALE

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent -> [0,1]-ish image in f32; not clamped."""
        return self.vae.decode(z / VAE_SCALE).float() / 2.0 + 0.5

    def one_step(self, z_init: torch.Tensor, y: torch.Tensor, y_mask: Optional[torch.Tensor] = None,
                 c: Optional[torch.Tensor] = None) -> torch.Tensor:
        """eps at t=maxt -> x0 (f32); ``c``: the ControlNet condition latent."""
        t = torch.full((z_init.shape[0],), self.maxt, dtype=torch.int64, device=z_init.device)
        out = self.dit(z_init, t.float(), y, y_mask=y_mask, c=c, control_depth=self.control_depth)
        return eps_to_x0(self.sched, out[..., : z_init.shape[-1]], z_init, t)

    @torch.inference_mode()
    def process(self, lq: torch.Tensor, y: torch.Tensor, y_mask=None, *,
                use_swinir: bool = True, color_fix: str = "wavelet", use_control: bool = False) -> torch.Tensor:
        """Non-tiled restoration of a x64-sized [0,1] NHWC batch; y: (B, L,
        caption_channels). The color fix applies here too, as in the JAX
        package, so tiled and untiled outputs agree."""
        stage1 = self.clean(lq) if use_swinir else lq
        z_init = self.encode(stage1)
        z0 = self.one_step(z_init, y, y_mask, c=z_init if use_control else None)
        out = _color_fix(self.decode(z0), stage1.float(), color_fix)
        return out.clamp(0.0, 1.0)

    @torch.inference_mode()
    def process_tiled(self, lq: torch.Tensor, y: torch.Tensor, y_mask=None, *,
                      tile_size: int = 512, tile_stride: int = 448,
                      use_swinir: bool = True, color_fix: str = "wavelet",
                      tile_batch: int = 4, use_control: bool = False) -> torch.Tensor:
        """Tiled restoration: latent tiles through the one-step DiT (up to
        ``tile_batch`` tiles per forward) with a sum/count overlap average,
        then each averaged latent tile decoded, color-fixed against the
        SwinIR pixels and overlap-averaged in pixel space."""
        b, h, w, _ = lq.shape
        f = self.latent_factor
        lt, ls = tile_size // f, tile_stride // f
        stage1 = self.clean(lq) if use_swinir else lq
        z_init = self.encode(stage1)
        offsets = tile_grid(h // f, w // f, lt, ls).tolist()

        zsum = torch.zeros(z_init.shape, dtype=torch.float32, device=lq.device)
        cnt = torch.zeros((b, h // f, w // f, 1), dtype=torch.float32, device=lq.device)
        for c0 in range(0, len(offsets), tile_batch):
            chunk = offsets[c0 : c0 + tile_batch]
            tiles = torch.cat([z_init[:, hi : hi + lt, wi : wi + lt] for hi, wi in chunk])
            y_rep = y.repeat(len(chunk), 1, 1)
            m_rep = None if y_mask is None else y_mask.repeat(len(chunk), 1)
            outs = self.one_step(tiles, y_rep, m_rep, c=tiles if use_control else None)
            outs = outs.reshape(len(chunk), b, lt, lt, -1)
            for (hi, wi), out in zip(chunk, outs):
                zsum[:, hi : hi + lt, wi : wi + lt] += out
                cnt[:, hi : hi + lt, wi : wi + lt] += 1.0
        z_avg = (zsum / cnt).to(z_init.dtype)

        psum = torch.zeros((b, h, w, 3), dtype=torch.float32, device=lq.device)
        pcnt = torch.zeros((b, h, w, 1), dtype=torch.float32, device=lq.device)
        for hi, wi in offsets:
            img = self.decode(z_avg[:, hi : hi + lt, wi : wi + lt])
            ph, pw = hi * f, wi * f
            ref = stage1[:, ph : ph + lt * f, pw : pw + lt * f].float()
            psum[:, ph : ph + lt * f, pw : pw + lt * f] += _color_fix(img, ref, color_fix)
            pcnt[:, ph : ph + lt * f, pw : pw + lt * f] += 1.0
        return (psum / pcnt).clamp(0.0, 1.0)
