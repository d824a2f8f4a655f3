"""MANIQA, the NTIRE'22 no-reference IQA network: ``instarevive_tpu/utils/maniqa.py``
in PyTorch.

A ViT-B/8 trunk (timm ``vit_base_patch8_224``) on a 224x224 crop; the tokens
of its blocks 6-9 (CLS dropped) concatenated to (784, 3072); two transposed
attention blocks (attention across channels, q/k/v maps over the 784
positions, with the official ``(attn @ v).transpose(1, 2).reshape(B, C, N)``
permutation); a 1x1 conv to 768; a Swin stage (two layers of two blocks,
window 4, 4 heads, the second block of each shifted by 2, relative-position
bias; ``x = 0.8 * layer(x) + x``); two more transposed blocks, a 1x1 conv to
384, a second Swin stage; then a score branch (ReLU) and a weight branch
(sigmoid) over the 784 tokens, averaged by the weights.

Parameter names are the official checkpoint's (IIGROUP/MANIQA, pyiqa), as
``state_dict_from_torch`` reads them; ``convert/from_jax.maniqa_params_to_torch``
maps the JAX package's params. ``score`` crops on the host as the JAX package
does (the centre, or ``num_crops`` crops drawn from
``np.random.default_rng(seed)``, reflect-padded below 224). Plain torch ops.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.convert.checkpoint_layouts import TakeKeys
from instarevive_tpu_torch.nn.layers import device_constant
from instarevive_tpu_torch.ops import window as W

_VIT_DEPTH, _VIT_DIM, _VIT_HEADS, _PATCH = 12, 768, 12, 8
_IMG = 224
_GRID = _IMG // _PATCH  # 28
_N = _GRID * _GRID  # 784
_FEAT_BLOCKS = (6, 7, 8, 9)
_EMBED = 768
_NUM_TAB = 2
_WINDOW, _SWIN_HEADS, _SWIN_LAYERS, _SWIN_DEPTH = 4, 4, 2, 2
_SCALE = 0.8  # a Swin layer's residual scale
_DIM_MLP = 768
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _ViTAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.qkv, self.proj = nn.Linear(_VIT_DIM, 3 * _VIT_DIM), nn.Linear(_VIT_DIM, _VIT_DIM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, _VIT_HEADS, -1).permute(2, 0, 3, 1, 4)
        a = (q @ k.transpose(-1, -2) * (d // _VIT_HEADS) ** -0.5).softmax(-1)
        return self.proj((a @ v).transpose(1, 2).reshape(b, n, d))


class _ViTBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(_VIT_DIM, eps=1e-6), nn.LayerNorm(_VIT_DIM, eps=1e-6)
        self.attn, self.mlp = _ViTAttention(), _Mlp(_VIT_DIM, 4 * _VIT_DIM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _ViT(nn.Module):
    def __init__(self):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, _VIT_DIM, _PATCH, stride=_PATCH)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, _VIT_DIM))
        self.pos_embed = nn.Parameter(torch.zeros(1, _N + 1, _VIT_DIM))
        self.blocks = nn.ModuleList(_ViTBlock() for _ in range(_VIT_DEPTH))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised NCHW crops -> (B, 784, 3072): blocks 6-9's tokens."""
        t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(t.shape[0], 1, _VIT_DIM), t], 1) + self.pos_embed
        feats = []
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in _FEAT_BLOCKS:
                feats.append(t[:, 1:])
        return torch.cat(feats, 2)


class _TABlock(nn.Module):
    """Attention across channels of (B, C, N); q, k, v map the N positions."""

    def __init__(self):
        super().__init__()
        self.c_q, self.c_k, self.c_v = (nn.Linear(_N, _N) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, n = x.shape
        a = (self.c_q(x) @ self.c_k(x).transpose(-1, -2) * n**-0.5).softmax(-1)
        return (a @ self.c_v(x)).transpose(1, 2).reshape(b, c, n) + x


class _WindowAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv, self.proj = nn.Linear(dim, 3 * dim), nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * _WINDOW - 1) ** 2, _SWIN_HEADS))

    def forward(self, x: torch.Tensor, shift: bool) -> torch.Tensor:
        """x: (B, H, W, C): cyclic shift by -2 where ``shift``, windowed
        attention with the bias (and the shift mask), reverse, shift back."""
        b, h, w, c = x.shape
        if shift:
            x = W.cyclic_shift(x, _WINDOW // 2)
        n = _WINDOW * _WINDOW
        xw = W.window_partition(x, _WINDOW)  # (B * nW, n, C)
        q, k, v = self.qkv(xw).view(-1, n, 3, _SWIN_HEADS, c // _SWIN_HEADS).permute(2, 0, 3, 1, 4)
        s = q @ k.transpose(-1, -2) * (c // _SWIN_HEADS) ** -0.5
        idx = device_constant(W.relative_position_index, (_WINDOW,), x.device).reshape(-1)
        s = s + self.relative_position_bias_table[idx].view(n, n, -1).permute(2, 0, 1)[None]
        if shift:
            mask = device_constant(W.shift_attn_mask, (h, w, _WINDOW, _WINDOW // 2), x.device)
            s = (s.view(b, -1, _SWIN_HEADS, n, n) + mask[None, :, None]).view(-1, _SWIN_HEADS, n, n)
        o = self.proj((s.softmax(-1) @ v).transpose(1, 2).reshape(-1, n, c))
        o = W.window_reverse(o, _WINDOW, h, w)
        return W.cyclic_unshift(o, _WINDOW // 2) if shift else o


class _SwinBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(dim, eps=1e-5), nn.LayerNorm(dim, eps=1e-5)
        self.attn, self.mlp = _WindowAttention(dim), _Mlp(dim, _DIM_MLP)

    def forward(self, x: torch.Tensor, shift: bool) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), shift)
        return x + self.mlp(self.norm2(x))


class _SwinStage(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(nn.Module() for _ in range(_SWIN_LAYERS))
        for layer in self.layers:
            layer.blocks = nn.ModuleList(_SwinBlock(dim) for _ in range(_SWIN_DEPTH))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x_in = x
            for d, blk in enumerate(layer.blocks):
                x = blk(x, shift=d % 2 == 1)
            x = _SCALE * x + x_in
        return x


class MANIQA(nn.Module):
    """The network: ``forward`` on (B, 224, 224, 3) [0, 1] crops -> (B,)
    scores; ``score`` on images of any size."""

    def __init__(self, num_crops: int = 1, seed: int = 0):
        super().__init__()
        self.num_crops, self.seed = num_crops, seed
        self.vit = _ViT()
        self.tablock1 = nn.ModuleList(_TABlock() for _ in range(_NUM_TAB))
        self.tablock2 = nn.ModuleList(_TABlock() for _ in range(_NUM_TAB))
        self.conv1 = nn.Conv2d(4 * _EMBED, _EMBED, 1)
        self.conv2 = nn.Conv2d(_EMBED, _EMBED // 2, 1)
        self.swintransformer1, self.swintransformer2 = _SwinStage(_EMBED), _SwinStage(_EMBED // 2)
        half = _EMBED // 2
        self.fc_score = nn.Sequential(nn.Linear(half, half), nn.ReLU(), nn.Identity(), nn.Linear(half, 1), nn.ReLU())
        self.fc_weight = nn.Sequential(nn.Linear(half, half), nn.ReLU(), nn.Identity(), nn.Linear(half, 1),
                                       nn.Sigmoid())

    def forward(self, img01: torch.Tensor) -> torch.Tensor:
        mean, std = (torch.from_numpy(v).to(img01.device, img01.dtype) for v in (_MEAN, _STD))
        x = ((img01 - mean) / std).permute(0, 3, 1, 2)
        x = self.vit(x).transpose(1, 2)  # (B, C, N)
        for blk in self.tablock1:
            x = blk(x)
        x = self.conv1(x.reshape(-1, 4 * _EMBED, _GRID, _GRID)).permute(0, 2, 3, 1)
        x = self.swintransformer1(x)
        x = x.permute(0, 3, 1, 2).reshape(-1, _EMBED, _N)
        for blk in self.tablock2:
            x = blk(x)
        x = self.conv2(x.reshape(-1, _EMBED, _GRID, _GRID)).permute(0, 2, 3, 1)
        tok = self.swintransformer2(x).reshape(-1, _N, _EMBED // 2)
        s, w = self.fc_score(tok), self.fc_weight(tok)
        return (s * w).sum(dim=(1, 2)) / torch.clamp(w.sum(dim=(1, 2)), min=1e-8)

    @torch.no_grad()
    def score(self, img01: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) or (H, W, 3) [0, 1] images -> (B,) scores, the mean
        over the crops."""
        img01 = np.asarray(img01, np.float32)
        if img01.ndim == 3:
            img01 = img01[None]
        _, h, w, _ = img01.shape
        rng = np.random.default_rng(self.seed)
        scores = []
        for _ in range(self.num_crops):
            if self.num_crops == 1 or (h == _IMG and w == _IMG):
                top, left = max((h - _IMG) // 2, 0), max((w - _IMG) // 2, 0)
            else:
                top = rng.integers(0, max(h - _IMG, 0) + 1)
                left = rng.integers(0, max(w - _IMG, 0) + 1)
            crop = img01[:, top: top + _IMG, left: left + _IMG]
            if crop.shape[1] != _IMG or crop.shape[2] != _IMG:
                crop = np.pad(crop, ((0, 0), (0, _IMG - crop.shape[1]), (0, _IMG - crop.shape[2]), (0, 0)),
                              mode="reflect")
            scores.append(self(torch.from_numpy(crop).to(self.conv1.weight.device)).cpu().numpy())
        return np.mean(scores, axis=0)


def state_dict_from_torch(sd: Mapping) -> Dict[str, torch.Tensor]:
    """``MANIQA``'s state dict from the official checkpoint: every key of
    the network taken; the trunk's unused ``vit.norm``, ``vit.head`` and
    ``vit.pre_logits`` and the Swin buffers (``relative_position_index``,
    ``attn_mask``, recomputed here) skipped; anything else raises."""
    src = TakeKeys(sd, "MANIQA")
    with torch.device("meta"):  # names and shapes only
        layout = MANIQA().state_dict()
    out = {k: torch.as_tensor(src.take(k)).float().reshape(ref.shape) for k, ref in layout.items()}
    src.done(ignore=("vit.norm.", "vit.head", "vit.pre_logits", ".relative_position_index", ".attn_mask"))
    return out
