"""SD-2.1 UNet and DiffBIR-style ControlNet (``instarevive_tpu/models/unet.py``).

The openaimodel ``UNetModel`` with ``SpatialTransformer`` cross-attention at
the ``configs/cldm.yaml`` widths (model_channels 320, channel_mult (1,2,4,4),
2 res blocks, attention at ds 1/2/4, head dim 64, linear proj, context 1024),
the ``BasicTransformerBlock`` (self-attention, cross-attention, GEGLU), and the
ControlNet: an encoder copy over concat(x, hint) whose zero convolutions give
one residual per input block and one for the middle, which the UNet adds on
its middle block and its skips (``controlled_unet_apply``).

Module names follow the openaimodel key layout (``input_blocks.N.0.in_layers.0``,
``zero_convs.N.0``, ``middle_block_out.0``, ``output_blocks.N.M.conv``,
``out.2``, ...) that ``convert/from_jax.unet_params_to_torch`` writes, so an
exported state dict loads with ``strict=True``.

Inputs and outputs are NHWC as in the JAX package; inside, activations are
NCHW tensors laid out channels-last in memory, so the token view of a
transformer (B, H*W, C) is a view, not a copy. Every attention goes through
``ops/attention.attention``: on the card the flash kernels at head dim 64
(forward, and the backward kernels where an input takes a gradient), on the
CPU the plain ``sdpa``. GroupNorm (32 groups, eps 1e-5), SiLU, the
convolutions and the nearest 2x upsample are torch ops, as the JAX UNet leaves
them to XLA; GroupNorm and LayerNorm take their statistics in f32. bf16
compute from f32 masters is the per-layer ``compute_dtype`` of
``nn.layers`` (``set_compute_dtype``). ``use_checkpoint`` recomputes every
ResBlock and SpatialTransformer in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from instarevive_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear, timestep_embedding
from instarevive_tpu_torch.ops.attention import attention

# Weights the reference initialises to zero (the ResBlock's last conv, a
# transformer's proj_out, the zero convolutions, the UNet's last conv), by
# the suffix of their torch names.
ZERO_INIT = ("out_layers.3.weight", "proj_out.weight", "out.2.weight")


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with 32 groups and eps 1e-5, statistics and affine in f32,
    output in the input's dtype (flax's GroupNorm with ``dtype=``)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps).to(x.dtype)


def _run(module: nn.Module, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class ResBlock(nn.Module):
    """openaimodel ResBlock (no scale-shift norm): GN, SiLU, conv; plus the
    embedding's projection; GN, SiLU, conv; a 1x1 skip where the width
    changes."""

    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(cin), nn.SiLU(), Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_dim, cout))
        self.out_layers = nn.Sequential(GroupNorm32(cout), nn.SiLU(), nn.Identity(), Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = Conv2d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class CrossAttention(nn.Module):
    """q from x, k and v from the context (x itself for self-attention), no
    biases; heads of ``dim / heads`` (64 at the SD-2.1 widths)."""

    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(context_dim, dim, bias=False)
        self.to_v = Linear(context_dim, dim, bias=False)
        self.to_out = nn.Sequential(Linear(dim, dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.heads
        hd = c // h

        def split(t):  # (B, N, C) -> (B, heads, N, hd): a strided view; the kernel wrapper makes it contiguous
            return t.reshape(b, -1, h, hd).transpose(1, 2)

        out = attention(split(self.to_q(x)), split(self.to_k(context)), split(self.to_v(context)), scale=hd**-0.5)
        return self.to_out(out.transpose(1, 2).reshape(b, n, c))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim, eps=1e-5), LayerNorm(dim, eps=1e-5), LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self.attn1(y, y)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN, linear proj_in to tokens, the transformer blocks, linear proj_out,
    residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim) for _ in range(depth)])
        self.proj_out = Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return x + self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Block(nn.ModuleList):
    """One entry of input_blocks / middle_block / output_blocks: its layers in
    order, each given (h, emb, context) as it takes them."""

    def forward(self, h, emb, context, remat: bool):
        for layer in self:
            if isinstance(layer, ResBlock):
                h = _run(layer, remat, h, emb)
            elif isinstance(layer, SpatialTransformer):
                h = _run(layer, remat, h, context)
            else:
                h = layer(h)
        return h


class UNetBackbone(nn.Module):
    """The UNet (``is_controlnet=False``: NHWC noise prediction) or the
    ControlNet's encoder copy (``is_controlnet=True``: the list of its
    zero-conv residuals, NHWC), with the JAX package's constructor
    arguments."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4, model_channels: int = 320,
                 num_res_blocks: int = 2, attention_ds: Sequence[int] = (1, 2, 4),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_head_channels: int = 64,
                 context_dim: int = 1024, transformer_depth: int = 1, is_controlnet: bool = False,
                 use_checkpoint: bool = False):
        super().__init__()
        mc = model_channels
        self.model_channels, self.is_controlnet, self.use_checkpoint = mc, is_controlnet, use_checkpoint
        self.channel_mult, self.num_res_blocks = tuple(channel_mult), num_res_blocks
        self.attention_ds, self.num_head_channels = tuple(attention_ds), num_head_channels
        emb_dim = 4 * mc
        self.time_embed = nn.Sequential(Linear(mc, emb_dim), nn.SiLU(), Linear(emb_dim, emb_dim))

        def st(ch):
            return SpatialTransformer(ch, ch // num_head_channels, context_dim, transformer_depth)

        def zero_conv(ch):
            return nn.Sequential(Conv2d(ch, ch, 1))

        self.input_blocks = nn.ModuleList([_Block([Conv2d(in_channels, mc, 3, padding=1)])])
        if is_controlnet:
            self.zero_convs = nn.ModuleList([zero_conv(mc)])
        skips, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mc * mult, emb_dim)]
                ch = mc * mult
                if ds in self.attention_ds:
                    layers.append(st(ch))
                self.input_blocks.append(_Block(layers))
                skips.append(ch)
                if is_controlnet:
                    self.zero_convs.append(zero_conv(ch))
            if level != len(channel_mult) - 1:
                self.input_blocks.append(_Block([Downsample(ch)]))
                skips.append(ch)
                ds *= 2
                if is_controlnet:
                    self.zero_convs.append(zero_conv(ch))
        self.middle_block = _Block([ResBlock(ch, ch, emb_dim), st(ch), ResBlock(ch, ch, emb_dim)])
        if is_controlnet:
            self.middle_block_out = zero_conv(ch)
            return

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for j in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), mc * mult, emb_dim)]
                ch = mc * mult
                if ds in self.attention_ds:
                    layers.append(st(ch))
                if level and j == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(_Block(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv2d(ch, out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                control: Optional[Sequence[torch.Tensor]] = None, only_mid_control: bool = False):
        """x (B, H, W, Cin) NHWC (the hint already concatenated for the
        ControlNet); timesteps (B,) taken as f32; context (B, L, context_dim).
        Returns (B, H, W, Cout), or the ControlNet's residuals (NHWC)."""
        remat = self.use_checkpoint
        emb = self.time_embed(timestep_embedding(timesteps.float(), self.model_channels))
        h = x.permute(0, 3, 1, 2)
        hs, outs = [], []
        for i, block in enumerate(self.input_blocks):
            h = block(h, emb, context, remat)
            hs.append(h)
            if self.is_controlnet:
                outs.append(self.zero_convs[i](h))
        h = self.middle_block(h, emb, context, remat)
        if self.is_controlnet:
            outs.append(self.middle_block_out(h))
            return [o.permute(0, 2, 3, 1) for o in outs]

        control = None if control is None else [c.permute(0, 3, 1, 2) for c in control]
        if control is not None:
            h = h + control.pop()
        for block in self.output_blocks:
            skip = hs.pop()
            if control is not None and not only_mid_control:
                skip = skip + control.pop()
            h = block(torch.cat([h, skip], dim=1), emb, context, remat)
        return self.out(h).permute(0, 2, 3, 1)

    def spatial_transformers(self) -> List[SpatialTransformer]:
        return [m for m in self.modules() if isinstance(m, SpatialTransformer)]


class ControlNet(UNetBackbone):
    """The DiffBIR ControlNet: the encoder copy over concat(x, hint); its keys
    are the backbone's own."""

    def __init__(self, **kw):
        super().__init__(**dict(kw, is_controlnet=True))

    def forward(self, x, hint, timesteps, context):  # noqa: D102
        return super().forward(torch.cat([x, hint], dim=-1), timesteps, context)


def controlled_unet_apply(unet: UNetBackbone, controlnet: UNetBackbone, x: torch.Tensor, hint: torch.Tensor,
                          t: torch.Tensor, context: torch.Tensor, only_mid_control: bool = False) -> torch.Tensor:
    """ControlledUnetModel.forward: the ControlNet's residuals over
    concat(x, hint), then the UNet with them added on its middle and skips."""
    control = UNetBackbone.forward(controlnet, torch.cat([x, hint], dim=-1), t, context)
    return unet(x, t, context, control=control, only_mid_control=only_mid_control)


def zero_init_(module: UNetBackbone) -> UNetBackbone:
    """Zero the weights the reference initialises to zero (their biases are
    zero already after ``init_unet``'s flax-style init)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(ZERO_INIT) or name.startswith(("zero_convs.", "middle_block_out.")):
                p.zero_()
    return module
