"""One-step blind restoration pipeline (``instarevive_tpu/pipelines/restore.py``).

SwinIR clean -> VAE encode (posterior mode x 0.18215) as the init latent ->
one DiT forward at t=400 -> eps to x0 -> VAE decode -> color fix -> clamp,
with a tiled mode that overlap-averages in latent space and again in pixel
space. Images and latents are NHWC. Stages run on the whole batch; tiles
are Python loops, with the DiT run on up to ``tile_batch`` tiles at once.

The parallel entry points (the JAX package's ``jitted_sharded/_tp/_sp/_pp``)
return plain callables ``(lq, y, y_mask=None) -> restored batch``, the whole
batch on every rank of their group (``parallel/``):

* ``sharded(group)``: data parallelism, each rank restores its rows of the
  batch (a multiple of the group size) and the rows are gathered back;
* ``tp(tensor_group, data_group)``: the DiT's blocks laid out for tensor
  parallelism over ``tensor_group`` (in place: the pipeline holds this rank's
  slices from then on), the batch split over ``data_group`` when given;
* ``sp(group)``: the DiT's tokens split over ``group``; the token count
  (H/16)(W/16) must be a multiple of the group size;
* ``pp(group, microbatches)``: the DiT's block stack as a GPipe pipeline over
  ``group`` (in place: the pipeline keeps this rank's stage of blocks only);
  the batch must be a multiple of ``microbatches``.

SwinIR, the VAE and the color fix run whole on every rank under tp, sp and
pp, as in the JAX package. Plain ``process`` only, without the ControlNet
branch.
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
from instarevive_tpu_torch.parallel.mesh import batch_slice, gather_batch, group_rank

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
                 c: Optional[torch.Tensor] = None, dit_forward=None) -> torch.Tensor:
        """eps at t=maxt -> x0 (f32); ``c``: the ControlNet condition latent;
        ``dit_forward(z, t, y, y_mask)`` in place of the DiT's own forward."""
        t = torch.full((z_init.shape[0],), self.maxt, dtype=torch.int64, device=z_init.device)
        if dit_forward is not None:
            if c is not None:
                raise NotImplementedError("a parallel DiT forward has no ControlNet branch")
            out = dit_forward(z_init, t.float(), y, y_mask)
        else:
            out = self.dit(z_init, t.float(), y, y_mask=y_mask, c=c, control_depth=self.control_depth)
        return eps_to_x0(self.sched, out[..., : z_init.shape[-1]], z_init, t)

    @torch.inference_mode()
    def process(self, lq: torch.Tensor, y: torch.Tensor, y_mask=None, *,
                use_swinir: bool = True, color_fix: str = "wavelet", use_control: bool = False,
                dit_forward=None) -> torch.Tensor:
        """Non-tiled restoration of a x64-sized [0,1] NHWC batch; y: (B, L,
        caption_channels). The color fix applies here too, as in the JAX
        package, so tiled and untiled outputs agree. ``dit_forward(z, t, y,
        y_mask)`` replaces the DiT's forward (the parallel entry points)."""
        stage1 = self.clean(lq) if use_swinir else lq
        z_init = self.encode(stage1)
        z0 = self.one_step(z_init, y, y_mask, c=z_init if use_control else None, dit_forward=dit_forward)
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

    # ---- parallel entry points (module docstring) ----------------------------

    def sharded(self, group=None, **kw):
        """Data parallelism over ``group``: each rank restores its rows."""
        rank, size = group_rank(group)

        def call(lq, y, y_mask=None):
            part = self.process(batch_slice(lq, rank, size), batch_slice(y, rank, size),
                                None if y_mask is None else batch_slice(y_mask, rank, size), **kw)
            return gather_batch(part, group)

        return call

    def tp(self, tensor_group, data_group=None, **kw):
        """Tensor parallelism of the DiT over ``tensor_group`` (data
        parallelism over ``data_group`` on top)."""
        from instarevive_tpu_torch.parallel.tp import tp_dit

        tp_dit(self.dit, tensor_group)
        return self.sharded(data_group, **kw)

    def sp(self, group, **kw):
        """Sequence parallelism of the DiT's tokens over ``group``."""
        from instarevive_tpu_torch.parallel.sp import pixart_sp_forward

        def dit_forward(z, t, y, y_mask):
            return pixart_sp_forward(self.dit, group, z, t, y, y_mask)

        return lambda lq, y, y_mask=None: self.process(lq, y, y_mask, dit_forward=dit_forward, **kw)

    def pp(self, group, microbatches: int = 2, **kw):
        """The DiT's block stack as a GPipe pipeline over ``group``."""
        from instarevive_tpu_torch.parallel.pp import PipelineDiT

        stage = PipelineDiT(self.dit, group, microbatches)
        return lambda lq, y, y_mask=None: self.process(lq, y, y_mask, dit_forward=stage, **kw)
