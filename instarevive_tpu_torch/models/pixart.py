"""PixArt DiT backbone (``instarevive_tpu/models/pixart.py``), the one-step
generator at the InstaRevive v1 configuration (PixArt-XL-2: depth 28, hidden
1152, 16 heads of dim 72, patch 2, 300 caption tokens).

Latents are NHWC at the public surface; tokens are (B, N, D). adaLN-single
conditioning: one ``t_block`` projection shared by all blocks plus a
per-block ``scale_shift_table``. Self- and cross-attention go through
``attention``, hence the CUDA flash kernel on the card; the padded caption
mask is a (B, L) bool key mask. Parameter names follow the reference native
key layout (``blocks.0.attn.qkv.weight`` and so on).

``grad_checkpoint`` wraps each block in ``torch.utils.checkpoint`` (the
``remat_policy: full`` of the JAX package: a block's activations are
recomputed in the backward, so its attention forward kernel runs twice).

ControlNet-Half: built with ``control_depth`` N, the model holds N copied
blocks (``controlnet.{j}.copied_block``) with zero-initialised projections
(``controlnet.{j}.after_proj``, ``controlnet.0.before_proj``); ``forward(...,
c=, control_depth=)`` runs them on the condition latent.

Not ported yet (they raise if configured): KV compression, windowed blocks,
qk-norm, micro-conditioning and ``remat_policy: dots``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from instarevive_tpu_torch.nn.layers import (
    Conv2d, LayerNorm, Linear, Mlp, device_constant, timestep_embedding,
)
from instarevive_tpu_torch.ops.attention import attention


def sincos_pos_embed_2d(
    dim: int, h: int, w: int, pe_interpolation: float = 1.0, base_size: int = 16
) -> np.ndarray:
    """2-D sin-cos PE, PixArt convention: tokens row-major over (h, w); the
    first half of the dim encodes the (scaled) column, the second the row;
    each half is [sin | cos]."""
    gh = np.arange(h, dtype=np.float64) / (h / base_size) / pe_interpolation
    gw = np.arange(w, dtype=np.float64) / (w / base_size) / pe_interpolation
    grid_w, grid_h = np.meshgrid(gw, gh)

    def embed_1d(pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float64) / (dim / 4.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([embed_1d(grid_w), embed_1d(grid_h)], axis=1).astype(np.float32)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, h, c // h).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.num_heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        scale = (x.shape[-1] // h) ** -0.5
        return self.proj(_merge(attention(_heads(q, h), _heads(k, h), _heads(v, h), scale=scale)))


class CrossAttention(nn.Module):
    """Image-token queries over the caption tokens, with a padded key mask."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = Linear(dim, dim)
        self.kv_linear = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, kv_mask=None) -> torch.Tensor:
        h = self.num_heads
        k, v = self.kv_linear(cond).chunk(2, dim=-1)
        scale = (x.shape[-1] // h) ** -0.5
        out = attention(_heads(self.q_linear(x), h), _heads(k, h), _heads(v, h),
                        kv_mask=kv_mask, scale=scale)
        return self.proj(_merge(out))


class PixArtBlock(nn.Module):
    """DiT block with adaLN-single."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.attn = SelfAttention(dim, num_heads)
        self.cross_attn = CrossAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.scale_shift_table = nn.Parameter(torch.zeros(6, dim))

    def forward(self, x, y, t6, kv_mask=None):
        """x: (B,N,D) tokens; y: (B,L,D) caption tokens; t6: (B,6,D). The
        f32 table promotes the modulations, hence the residual stream, to
        f32 under bf16 compute, as in the JAX package."""
        mods = self.scale_shift_table[None] + t6
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods.unbind(1)
        h1 = self.norm1(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        x = x + gate_msa[:, None] * self.attn(h1)
        x = x + self.cross_attn(x, y, kv_mask)
        h2 = self.norm2(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        return x + gate_mlp[:, None] * self.mlp(h2)


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, p: int):
        super().__init__()
        self.proj = Conv2d(cin, dim, p, stride=p)


class TimestepEmbedder(nn.Module):
    """sinusoid(256) -> Linear -> SiLU -> Linear."""

    def __init__(self, hidden: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(Linear(freq_dim, hidden), nn.SiLU(), Linear(hidden, hidden))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.freq_dim))


class CaptionEmbedder(nn.Module):
    """T5-feature projection; ``y_embedding`` is the learned unconditional
    caption, which the CLI uses as the prompt when none is given."""

    def __init__(self, hidden: int, in_channels: int, token_num: int):
        super().__init__()
        self.y_proj = Mlp(in_channels, hidden, hidden)
        self.register_buffer("y_embedding", torch.zeros(token_num, in_channels))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.y_proj(y)


class T2IFinalLayer(nn.Module):
    def __init__(self, hidden: int, out_features: int):
        super().__init__()
        self.norm_final = LayerNorm(hidden, eps=1e-6, elementwise_affine=False)
        self.linear = Linear(hidden, out_features)
        self.scale_shift_table = nn.Parameter(torch.zeros(2, hidden))

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        shift, scale = (self.scale_shift_table[None] + t_emb[:, None]).unbind(1)
        return self.linear(self.norm_final(x) * (1 + scale[:, None]) + shift[:, None])


_UNPORTED = {
    "qk_norm": False, "kv_compress_sampling": None, "kv_compress_ratio": 1,
    "kv_compress_layers": (), "window_size": 0, "window_block_indexes": (),
    "micro_condition": False, "remat_policy": "full",
}


class ControlBlock(nn.Module):
    """One ControlNet-Half stage: a copied block and its zero-initialised skip
    projection; the first stage also projects the condition tokens in."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, first: bool):
        super().__init__()
        if first:
            self.before_proj = Linear(dim, dim)
        self.copied_block = PixArtBlock(dim, num_heads, mlp_ratio)
        self.after_proj = Linear(dim, dim)


class PixArt(nn.Module):
    """PixArt(MS) DiT with a per-input-size sincos position embedding, and
    with ``control_depth`` > 0 the ControlNet-Half branch."""

    def __init__(
        self,
        input_size: int = 64,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        pred_sigma: bool = True,
        caption_channels: int = 4096,
        model_max_length: int = 120,
        class_dropout_prob: float = 0.1,
        pe_interpolation: float = 1.0,
        grad_checkpoint: bool = False,
        control_depth: int = 0,
        **unported,
    ):
        super().__init__()
        for key, value in unported.items():
            if key not in _UNPORTED:
                raise TypeError(f"unknown PixArt option {key!r}")
            if (tuple(value) if isinstance(value, list) else value) != _UNPORTED[key]:
                raise NotImplementedError(f"PixArt option {key}={value!r} is not ported yet")
        del class_dropout_prob  # training-time caption dropout
        self.patch_size, self.hidden_size = patch_size, hidden_size
        self.base_size = input_size // patch_size
        self.pe_interpolation = pe_interpolation
        self.out_channels = in_channels * 2 if pred_sigma else in_channels
        self.model_max_length = model_max_length
        self.caption_channels = caption_channels
        self.grad_checkpoint = grad_checkpoint
        self.x_embedder = _PatchEmbed(in_channels, hidden_size, patch_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.t_block = nn.Sequential(nn.SiLU(), Linear(hidden_size, 6 * hidden_size))
        self.y_embedder = CaptionEmbedder(hidden_size, caption_channels, model_max_length)
        self.blocks = nn.ModuleList(
            PixArtBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth)
        )
        self.final_layer = T2IFinalLayer(hidden_size, patch_size**2 * self.out_channels)
        if control_depth >= depth:
            raise ValueError(f"control_depth {control_depth} must be below depth {depth}")
        self.controlnet = nn.ModuleList(
            ControlBlock(hidden_size, num_heads, mlp_ratio, first=j == 0) for j in range(control_depth)
        )

    @property
    def depth(self) -> int:
        return len(self.blocks)

    def _block(self, blk, tokens, y_tokens, t6, y_mask, remat):
        if remat:  # the blocks draw no random numbers: no generator state to keep
            return checkpoint(blk, tokens, y_tokens, t6, y_mask, use_reentrant=False, preserve_rng_state=False)
        return blk(tokens, y_tokens, t6, y_mask)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor, y: torch.Tensor,
                y_mask: Optional[torch.Tensor] = None, c: Optional[torch.Tensor] = None,
                control_depth: int = 0) -> torch.Tensor:
        """x: (B,H,W,C) NHWC latent; timestep: (B,); y: (B,L,caption_channels);
        y_mask: (B,L) bool or None; c: the ControlNet condition latent, shaped
        as x, which turns on the first ``control_depth`` (at most the built
        count) control stages. Returns (B,H,W,out_channels)."""
        b, hh, ww, _ = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        pe = None

        def embed(latent):
            nonlocal pe
            tokens = self.x_embedder.proj(latent.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
            if pe is None:
                pe = device_constant(sincos_pos_embed_2d,
                                     (self.hidden_size, gh, gw, self.pe_interpolation, self.base_size), tokens.device)
            return tokens + pe.to(tokens.dtype)[None]

        tokens = embed(x)
        t_emb = self.t_embedder(timestep)
        t6 = self.t_block(t_emb).reshape(b, 6, self.hidden_size)
        y_tokens = self.y_embedder(y)
        remat = self.grad_checkpoint and torch.is_grad_enabled()
        if c is None:
            for blk in self.blocks:
                tokens = self._block(blk, tokens, y_tokens, t6, y_mask, remat)
        else:
            if control_depth > len(self.controlnet):
                raise ValueError(f"control_depth {control_depth}: the model was built with {len(self.controlnet)}")
            # ControlNet-Half: base block 0; stage j's skip feeds base block j + 1
            c_tokens = embed(c)
            tokens = self._block(self.blocks[0], tokens, y_tokens, t6, y_mask, remat)
            for j in range(control_depth):
                stage = self.controlnet[j]
                if j == 0:
                    c_tokens = tokens + stage.before_proj(c_tokens)
                c_tokens = self._block(stage.copied_block, c_tokens, y_tokens, t6, y_mask, remat)
                tokens = self._block(self.blocks[j + 1], tokens + stage.after_proj(c_tokens), y_tokens, t6, y_mask,
                                     remat)
            for blk in self.blocks[control_depth + 1:]:
                tokens = self._block(blk, tokens, y_tokens, t6, y_mask, remat)

        out = self.final_layer(tokens, t_emb)
        out = out.reshape(b, gh, gw, p, p, self.out_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, gh * p, gw * p, self.out_channels)
