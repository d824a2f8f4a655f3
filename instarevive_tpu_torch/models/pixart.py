"""PixArt DiT backbone (``instarevive_tpu/models/pixart.py``), the one-step
generator at the InstaRevive v1 configuration (PixArt-XL-2: depth 28, hidden
1152, 16 heads of dim 72, patch 2, 300 caption tokens).

Latents are NHWC at the public surface; tokens are (B, N, D). adaLN-single
conditioning: one ``t_block`` projection shared by all blocks plus a
per-block ``scale_shift_table``. Self- and cross-attention go through
``attention``, hence the CUDA flash kernel on the card; the padded caption
mask is a (B, L) bool key mask. Parameter names follow the reference native
key layout (``blocks.0.attn.qkv.weight`` and so on).

The JAX package's options, per block where it sets them per block:

* ``kv_compress_sampling`` / ``kv_compress_ratio`` r / ``kv_compress_layers``:
  those blocks' self-attention keys and values come from an r-fold smaller
  grid a side. ``uniform`` and ``ave`` take every r-th token of each row and
  column (the JAX package computes ``ave`` as ``uniform``); ``conv`` runs one
  depthwise stride-r convolution and one LayerNorm (``attn.sr``,
  ``attn.norm``), shared by k and v, on a grid that r divides;
* ``qk_norm``: LayerNorm over the full width of q and k (``attn.q_norm``,
  ``attn.k_norm``), before any compression or window;
* ``window_size`` / ``window_block_indexes``: those blocks attend within
  windows of the grid zero-padded to a multiple of the window, over the
  padded tokens too, as the JAX package does (no key mask);
* ``micro_condition``: image height, width and aspect ratio through
  ``csize_embedder`` and ``ar_embedder``, added to the timestep embedding
  (``forward(..., data_info=)``; by default the latent's own height, width
  and their ratio, as the JAX package takes them).

``grad_checkpoint`` wraps each block in ``torch.utils.checkpoint``. Under
``remat_policy: full`` a block's activations are all recomputed in the
backward, so its attention forward kernel runs twice. Under ``dots`` (JAX's
``dots_with_no_batch_dims_saveable``) the outputs of the 2-D products, every
``Linear``, are kept from the forward and the rest is recomputed: the
attention kernels run twice all the same, the products once.

ControlNet-Half: built with ``control_depth`` N, the model holds N copied
blocks (``controlnet.{j}.copied_block``, with block j's options) with
zero-initialised projections (``controlnet.{j}.after_proj``,
``controlnet.0.before_proj``); ``forward(..., c=, control_depth=)`` runs them
on the condition latent.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from instarevive_tpu_torch.nn.layers import (
    Conv2d, LayerNorm, Linear, Mlp, TokenGridConv, device_constant, timestep_embedding,
)
from instarevive_tpu_torch.ops.attention import attention
from instarevive_tpu_torch.ops.window import pad_to_multiple, window_partition, window_reverse

KV_SAMPLINGS = ("uniform", "ave", "conv")
REMAT_POLICIES = ("full", "dots")
# remat_policy "dots": what a checkpointed block keeps from its forward, the
# outputs of the 2-D products (a Linear on (B, N, C) is one addmm)
_SAVE_PRODUCTS = functools.partial(create_selective_checkpoint_contexts,
                                   [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


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
    """qkv, then optionally qk-norm, and either windows or KV compression
    (the module docstring); ``hw`` is the token grid."""

    def __init__(self, dim: int, num_heads: int, sampling: Optional[str] = None, sr_ratio: int = 1,
                 qk_norm: bool = False, window_size: int = 0):
        super().__init__()
        self.num_heads, self.window_size, self.sr_ratio = num_heads, window_size, sr_ratio
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        # a windowed block never compresses (the JAX package returns before it)
        self.sampling = sampling if sr_ratio > 1 and not window_size else None
        if self.sampling not in (None, *KV_SAMPLINGS):
            raise ValueError(f"kv_compress_sampling {sampling!r}: one of {KV_SAMPLINGS}")
        if self.sampling == "conv":
            self.sr = TokenGridConv(dim, sr_ratio)
            self.norm = LayerNorm(dim, eps=1e-5)
        self.q_norm = LayerNorm(dim, eps=1e-5) if qk_norm else None
        self.k_norm = LayerNorm(dim, eps=1e-5) if qk_norm else None

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        h = self.num_heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        scale = (x.shape[-1] // h) ** -0.5
        if self.window_size:
            return self.proj(self._windowed(q, k, v, hw, scale))
        if self.sampling is not None:
            k, v = self._compress(k, hw), self._compress(v, hw)
        return self.proj(_merge(attention(_heads(q, h), _heads(k, h), _heads(v, h), scale=scale)))

    def _compress(self, t: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        if self.sampling == "conv":
            return self.norm(self.sr(t, hw))
        b, _, c = t.shape
        r = self.sr_ratio
        return t.reshape(b, *hw, c)[:, ::r, ::r].reshape(b, -1, c)

    def _windowed(self, q, k, v, hw: Tuple[int, int], scale: float) -> torch.Tensor:
        (b, n, c), (gh, gw), win = q.shape, hw, self.window_size

        def windows(t):  # (B * nW, heads, win^2, head dim)
            t = pad_to_multiple(t.reshape(b, gh, gw, c), win, mode="constant")[0]
            return _heads(window_partition(t, win), self.num_heads)

        out = _merge(attention(windows(q), windows(k), windows(v), scale=scale))
        out = window_reverse(out, win, -(-gh // win) * win, -(-gw // win) * win)
        return out[:, :gh, :gw].reshape(b, n, c)


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
    """DiT block with adaLN-single; ``attn_options`` are ``SelfAttention``'s."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, **attn_options):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.attn = SelfAttention(dim, num_heads, **attn_options)
        self.cross_attn = CrossAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6, elementwise_affine=False)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.scale_shift_table = nn.Parameter(torch.zeros(6, dim))

    def forward(self, x, y, t6, kv_mask, hw):
        """x: (B,N,D) tokens on the (gh, gw) grid ``hw``; y: (B,L,D) caption
        tokens; t6: (B,6,D). The f32 table promotes the modulations, hence the
        residual stream, to f32 under bf16 compute, as in the JAX package."""
        mods = self.scale_shift_table[None] + t6
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods.unbind(1)
        h1 = self.norm1(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        x = x + gate_msa[:, None] * self.attn(h1, hw)
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


class SizeEmbedder(TimestepEmbedder):
    """Micro-conditioning: each scalar (image height or width, aspect
    ratio) through the timestep embedder's sinusoid and MLP; (B, K) ->
    (B, K * out_dim)."""

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        return super().forward(s.reshape(-1)).reshape(s.shape[0], -1)


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


class ControlBlock(nn.Module):
    """One ControlNet-Half stage: a copied block and its zero-initialised skip
    projection; the first stage also projects the condition tokens in."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, first: bool, **attn_options):
        super().__init__()
        if first:
            self.before_proj = Linear(dim, dim)
        self.copied_block = PixArtBlock(dim, num_heads, mlp_ratio, **attn_options)
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
        qk_norm: bool = False,
        kv_compress_sampling: Optional[str] = None,
        kv_compress_ratio: int = 1,
        kv_compress_layers: Sequence[int] = (),
        window_size: int = 0,
        window_block_indexes: Sequence[int] = (),
        micro_condition: bool = False,
        grad_checkpoint: bool = False,
        remat_policy: str = "full",
        control_depth: int = 0,
    ):
        super().__init__()
        del class_dropout_prob  # training-time caption dropout
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: one of {REMAT_POLICIES}")
        self.patch_size, self.hidden_size = patch_size, hidden_size
        self.base_size = input_size // patch_size
        self.pe_interpolation = pe_interpolation
        self.out_channels = in_channels * 2 if pred_sigma else in_channels
        self.model_max_length = model_max_length
        self.caption_channels = caption_channels
        self.grad_checkpoint, self.remat_policy = grad_checkpoint, remat_policy
        self.x_embedder = _PatchEmbed(in_channels, hidden_size, patch_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.micro_condition = micro_condition
        if micro_condition:  # a third of the width each for height and width, the rest for the aspect ratio
            self.csize_embedder = SizeEmbedder(hidden_size // 3)
            self.ar_embedder = SizeEmbedder(hidden_size - 2 * (hidden_size // 3))
        self.t_block = nn.Sequential(nn.SiLU(), Linear(hidden_size, 6 * hidden_size))
        self.y_embedder = CaptionEmbedder(hidden_size, caption_channels, model_max_length)

        def attn_options(i):
            sr = kv_compress_ratio if i in tuple(kv_compress_layers) else 1
            return dict(sampling=kv_compress_sampling if sr > 1 else None, sr_ratio=sr, qk_norm=qk_norm,
                        window_size=window_size if i in tuple(window_block_indexes) else 0)

        self.blocks = nn.ModuleList(
            PixArtBlock(hidden_size, num_heads, mlp_ratio, **attn_options(i)) for i in range(depth)
        )
        self.final_layer = T2IFinalLayer(hidden_size, patch_size**2 * self.out_channels)
        if control_depth >= depth:
            raise ValueError(f"control_depth {control_depth} must be below depth {depth}")
        self.controlnet = nn.ModuleList(
            ControlBlock(hidden_size, num_heads, mlp_ratio, first=j == 0, **attn_options(j))
            for j in range(control_depth)
        )

    @property
    def depth(self) -> int:
        return len(self.blocks)

    def _block(self, blk, tokens, y_tokens, t6, y_mask, hw, remat):
        if remat:  # the blocks draw no random numbers: no generator state to keep
            policy = {"context_fn": _SAVE_PRODUCTS} if self.remat_policy == "dots" else {}
            return checkpoint(blk, tokens, y_tokens, t6, y_mask, hw, use_reentrant=False, preserve_rng_state=False,
                              **policy)
        return blk(tokens, y_tokens, t6, y_mask, hw)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor, y: torch.Tensor,
                y_mask: Optional[torch.Tensor] = None, c: Optional[torch.Tensor] = None,
                control_depth: int = 0, data_info: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """x: (B,H,W,C) NHWC latent; timestep: (B,); y: (B,L,caption_channels);
        y_mask: (B,L) bool or None; c: the ControlNet condition latent, shaped
        as x, which turns on the first ``control_depth`` (at most the built
        count) control stages; data_info: with ``micro_condition``,
        {"img_hw": (B, 2), "aspect_ratio": (B, 1)}, by default the latent's
        (H, W) and H / W. Returns (B,H,W,out_channels)."""
        b, hh, ww, _ = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        hw = (gh, gw)
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
        if self.micro_condition:
            if data_info is None:
                hw_in = torch.stack([torch.full((b,), float(hh), device=x.device),
                                     torch.full((b,), float(ww), device=x.device)], dim=1)
                ar_in = torch.full((b, 1), hh / ww, device=x.device)
            else:
                hw_in, ar_in = (torch.as_tensor(data_info[key], dtype=torch.float32, device=x.device)
                                for key in ("img_hw", "aspect_ratio"))
            t_emb = t_emb + torch.cat([self.csize_embedder(hw_in), self.ar_embedder(ar_in)], dim=-1)
        t6 = self.t_block(t_emb).reshape(b, 6, self.hidden_size)
        y_tokens = self.y_embedder(y)
        remat = self.grad_checkpoint and torch.is_grad_enabled()
        if c is None:
            for blk in self.blocks:
                tokens = self._block(blk, tokens, y_tokens, t6, y_mask, hw, remat)
        else:
            if control_depth > len(self.controlnet):
                raise ValueError(f"control_depth {control_depth}: the model was built with {len(self.controlnet)}")
            # ControlNet-Half: base block 0; stage j's skip feeds base block j + 1
            c_tokens = embed(c)
            tokens = self._block(self.blocks[0], tokens, y_tokens, t6, y_mask, hw, remat)
            for j in range(control_depth):
                stage = self.controlnet[j]
                if j == 0:
                    c_tokens = tokens + stage.before_proj(c_tokens)
                c_tokens = self._block(stage.copied_block, c_tokens, y_tokens, t6, y_mask, hw, remat)
                tokens = self._block(self.blocks[j + 1], tokens + stage.after_proj(c_tokens), y_tokens, t6, y_mask,
                                     hw, remat)
            for blk in self.blocks[control_depth + 1:]:
                tokens = self._block(blk, tokens, y_tokens, t6, y_mask, hw, remat)

        out = self.final_layer(tokens, t_emb)
        out = out.reshape(b, gh, gw, p, p, self.out_channels).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, gh * p, gw * p, self.out_channels)
