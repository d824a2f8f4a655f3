"""SwinIR stage-1 degradation remover (``instarevive_tpu/models/swinir.py``).

The InstaRevive configuration: 8x pixel-unshuffle input, embed 180, 8 RSTB x
6 blocks, window 8, mlp_ratio 2, ``nearest+conv`` upsampler x8, so net 1x.
``upsampler=""`` is SwinIR's residual head instead (no unshuffle, sf 1):
``conv_last`` maps the features straight to 3 channels, added to the input.

Tokens stay a spatial NHWC map from end to end. A block's attention is
``qkv`` Linear -> the fused window-attention op (``ops/swin_attention.py``: on
the card one CUDA kernel that partitions into windows, splits heads, adds the
relative-position bias and the shift mask to f32 scores, takes the softmax and
P.V, and folds the cyclic shift into its addressing) -> ``proj`` Linear: no
roll, partition or reverse runs here. The JAX package keeps tokens
window-resident across each RSTB instead, a TPU layout choice that computes
the same function. The ``(heads, N, N)`` f32 bias is gathered from the table
once per module (``nn.layers.derived``), the shift mask once per geometry.

The convolutions run on NCHW views of the NHWC map, channels-last in memory
(``build_pipeline`` lays their weights out alike), so no transposes run
around them; the upsampler's nearest 2x is the NHWC upsample kernel
(``ops/norm_kernels.upsample2x_nearest``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.nn.layers import (
    Conv2d, DerivedCache, LayerNorm, Linear, Mlp, derived, device_constant, pixel_unshuffle,
)
from instarevive_tpu_torch.ops import window as W
from instarevive_tpu_torch.ops.norm_kernels import upsample2x_nearest
from instarevive_tpu_torch.ops.swin_attention import swin_window_attention

_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _rgb_mean() -> np.ndarray:
    return np.asarray(_RGB_MEAN, np.float64)  # cast to the activation dtype once per call, as the literal was


def _nhwc_conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC map: the permuted view is a channels-last NCHW
    tensor, and so is the result, whose view back is contiguous NHWC."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class WindowAttention(DerivedCache, nn.Module):
    """W-MSA with a relative-position bias on an NHWC map."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        # consumed in f32 even when the model computes in bf16
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads)
        )

    def bias(self) -> torch.Tensor:
        """The table gathered to (heads, N, N) f32, as the attention op reads
        it. For inference it is packed once, not per call; while the table
        takes a gradient it is gathered inside autograd on every call, so
        that the gradient reaches the table."""
        table = self.relative_position_bias_table

        def make(t=None):
            n = self.window**2
            idx = device_constant(W.relative_position_index, (self.window,), table.device).reshape(-1)
            t = table.detach() if t is None else t
            return t.float()[idx].reshape(n, n, self.num_heads).permute(2, 0, 1).contiguous()

        if table.requires_grad and torch.is_grad_enabled():
            return make(table)
        return derived(self, "bias", (table,), make)

    def forward(self, x: torch.Tensor, shift: int = 0, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C); mask: (nW, N, N) additive f32 for the windows of
        the map rolled by ``-shift``, or None."""
        hd = x.shape[-1] // self.num_heads
        out = swin_window_attention(self.qkv(x), self.bias(), mask, self.num_heads, self.window, hd**-0.5, shift)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float = 2.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C)."""
        b, h, w, c = x.shape
        win = self.window
        shift = self.shift if min(h, w) > win else 0
        mask = device_constant(W.shift_attn_mask, (h, w, win, shift), x.device) if shift > 0 else None
        x = x + self.attn(self.norm1(x), shift, mask)
        return x + self.mlp(self.norm2(x))


class ResidualGroup(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class RSTB(nn.Module):
    """Residual Swin Transformer Block group: blocks, then a 3x3 conv, plus the input."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.residual_group = ResidualGroup(dim, depth, num_heads, window, mlp_ratio)
        self.conv = Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc_conv(self.conv, self.residual_group(x)) + x


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)


class SwinIR(nn.Module):
    """SwinIR for degradation removal; NHWC [0, 1] in, same range out."""

    def __init__(
        self,
        embed_dim: int = 180,
        depths: Sequence[int] = (6,) * 8,
        num_heads: Sequence[int] = (6,) * 8,
        window: int = 8,
        mlp_ratio: float = 2.0,
        sf: int = 8,
        img_range: float = 1.0,
        upsampler: str = "nearest+conv",
        unshuffle: bool = True,
        unshuffle_scale: int = 8,
        num_feat: int = 64,
    ):
        super().__init__()
        if upsampler not in ("nearest+conv", ""):
            raise ValueError(f"SwinIR upsampler {upsampler!r}: 'nearest+conv' or '' (the residual head)")
        self.upsampler = upsampler
        self.window, self.sf, self.img_range = window, sf, img_range
        self.us = unshuffle_scale if unshuffle else 1
        conv_first = Conv2d(3 * self.us**2, embed_dim, 3, padding=1)
        self.conv_first = (
            nn.Sequential(nn.PixelUnshuffle(self.us), conv_first) if unshuffle else conv_first
        )
        self.patch_embed = _PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, nh, window, mlp_ratio) for d, nh in zip(depths, num_heads)
        )
        self.norm = LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, padding=1)
        if not upsampler:  # the residual head: conv_last on the features, added to the input
            self.conv_last = Conv2d(embed_dim, 3, 3, padding=1)
            return
        self.conv_before_upsample = nn.Sequential(
            Conv2d(embed_dim, num_feat, 3, padding=1), nn.LeakyReLU(0.01)
        )
        self.ups = {4: ("conv_up1", "conv_up2"), 8: ("conv_up1", "conv_up2", "conv_up3")}.get(
            sf, ("conv_up1",)
        )
        for name in self.ups:
            setattr(self, name, Conv2d(num_feat, num_feat, 3, padding=1))
        self.conv_hr = Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv_last = Conv2d(num_feat, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h0, w0, _ = x.shape
        net_scale = self.sf // self.us
        x, _, _ = W.pad_to_multiple(x, self.window * self.us, mode="reflect")
        mean = device_constant(_rgb_mean, (), x.device).to(x.dtype)  # copied to the card once, not every call
        x = (x - mean) * self.img_range

        if self.us > 1:  # the unshuffle in NHWC; conv_first[0] is its NCHW twin, kept for the key layout
            feat = _nhwc_conv(self.conv_first[1], pixel_unshuffle(x, self.us))
        else:
            feat = _nhwc_conv(self.conv_first, x)
        deep = self.patch_embed.norm(feat)
        for layer in self.layers:
            deep = layer(deep)
        deep = _nhwc_conv(self.conv_after_body, self.norm(deep))
        feat = (feat + deep).permute(0, 3, 1, 2)  # NCHW in shape, channels-last in memory, for the upsampler

        if self.upsampler:
            feat = self.conv_before_upsample(feat)
            for name in self.ups:
                up = upsample2x_nearest(feat.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                feat = F.leaky_relu(getattr(self, name)(up), 0.2)
            feat = F.leaky_relu(self.conv_hr(feat), 0.2)
            out = self.conv_last(feat).permute(0, 2, 3, 1)
        else:  # the input (net scale 1: no unshuffle, sf 1) plus the head's residual
            out = x + self.conv_last(feat).permute(0, 2, 3, 1)
        out = out.float() / self.img_range + mean.float()
        return out[:, : h0 * net_scale, : w0 * net_scale, :].to(x.dtype)
