"""AutoencoderKL, the SD VAE (``instarevive_tpu/models/vae.py``).

CompVis Encoder/Decoder with the reference key layout (``encoder.down.0.block.0.conv1``
and so on). Public methods take and return NHWC. Inside, tensors are NCHW in
shape and channels-last in memory: the NHWC input permuted to (0, 3, 1, 2) is
such a tensor, the library convolutions keep the layout, and the port's
kernels read the NHWC view, so nothing is transposed on the way.

GroupNorm is (32 groups, eps 1e-6) with f32 statistics. On the card
* both halves of every ResnetBlock, ``conv(silu(norm(x)))``, run as the fused
  GN+SiLU+conv3x3 kernel (``ops/gn_conv.py``), as the JAX package's VAE does
  under ``IR_GN_CONV``;
* the norms it does not cover (``AttnBlock.norm``, ``norm_out`` + SiLU) run as
  the moments and apply kernels (``ops/norm_kernels.py``);
* the decoder's nearest upsamples run as the upsample kernel;
* the mid-block attention runs as the flash kernel (``ops/attention.py``,
  head dim = 512 channels at the SD width).
The 1x1 convolutions, ``conv_in``, ``conv_out``, the stride-2 downsample and
the convolution after an upsample are library convolutions. On the CPU each
op runs its plain PyTorch version through the same code.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.nn.layers import Conv2d, GroupNorm
from instarevive_tpu_torch.ops.attention import attention
from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3
from instarevive_tpu_torch.ops.norm_kernels import upsample2x_nearest


def _gn(ch: int) -> GroupNorm:
    return GroupNorm(32, ch, eps=1e-6)


def _norm_silu_conv(norm: GroupNorm, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(silu(norm(x)))`` for a 3x3 SAME ``conv``, through the fused op."""
    w, bias = conv.hwio()
    y = gn_silu_conv3x3(x.permute(0, 2, 3, 1), *norm.affine_f32(), w, bias, norm.num_groups, norm.eps)
    return y.permute(0, 3, 1, 2)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _gn(cin)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _gn(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _norm_silu_conv(self.norm1, self.conv1, x)
        h = _norm_silu_conv(self.norm2, self.conv2, h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full attention over the spatial tokens."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _gn(ch)
        self.q = Conv2d(ch, ch, 1)
        self.k = Conv2d(ch, ch, 1)
        self.v = Conv2d(ch, ch, 1)
        self.proj_out = Conv2d(ch, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x)

        def tokens(t):  # (B, C, H, W) channels-last -> (B, 1, HW, C), a view
            return t.permute(0, 2, 3, 1).reshape(b, 1, h * w, c)

        out = attention(tokens(self.q(y)), tokens(self.k(y)), tokens(self.v(y)), scale=c**-0.5)
        return x + self.proj_out(out.reshape(b, h, w, c).permute(0, 3, 1, 2))


class _Level(nn.Module):
    """One resolution level: ``block`` ModuleList plus an optional resampler."""

    def __init__(self, blocks, resample: str, ch: int):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample == "down":
            self.downsample = nn.Module()
            self.downsample.conv = Conv2d(ch, ch, 3, stride=2)
        elif resample == "up":
            self.upsample = nn.Module()
            self.upsample.conv = Conv2d(ch, ch, 3, padding=1)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, double_z: bool = True):
        super().__init__()
        self.conv_in = Conv2d(3, ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = ch
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cin, ch * mult))
                cin = ch * mult
            last = i == len(ch_mult) - 1
            self.down.append(_Level(blocks, "none" if last else "down", cin))
        self.mid = _Mid(cin)
        self.norm_out = _gn(cin)
        self.conv_out = Conv2d(cin, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                # CompVis Downsample: asymmetric (0,1,0,1) pad + stride-2 VALID conv
                h = level.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid(h)
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, out_ch: int = 3):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels = []
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
            levels.insert(0, _Level(blocks, "up" if i != 0 else "none", block_in))
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(block_in)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample.conv(upsample2x_nearest(h.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
        return self.conv_out(self.norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    """KL autoencoder; NHWC in and out."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, embed_dim: int = 4):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior mean (latent_dist.mode()): (B,H,W,3) -> (B,H/f,W/f,embed_dim)."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return moments[:, : moments.shape[1] // 2].permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B,h,w,embed_dim) latent -> (B,H,W,3) image in [-1, 1]-ish."""
        return self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
