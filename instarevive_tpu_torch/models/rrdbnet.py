"""RRDBNet (Real-ESRGAN's background upsampler) and its tiling, the
PyTorch port of ``instarevive_tpu/models/rrdbnet.py``.

Residual-in-residual dense blocks; scales 2 and 1 pixel-unshuffle the input
by 2 and 4 first. Parameter names are Real-ESRGAN's ``RRDBNet`` state dict's
(``conv_first``, ``body.N.rdbK.convJ``, ``conv_body``, ``conv_up1``,
``conv_up2``, ``conv_hr``, ``conv_last``), so its checkpoints load as they
are; ``convert/from_jax.rrdbnet_params_to_torch`` maps the JAX package's.
NHWC in and out, as the JAX module; plain torch convolutions (cuDNN on the
card; the JAX package has no Pallas kernel here).

``tile_process`` is Real-ESRGAN's context-padded, non-overlapping tiling
(the JAX package runs it as one ``lax.scan``; here a loop over the tiles):
the image is reflect-padded to whole tiles plus ``tile_pad`` a side, each
``tile_size + 2 * tile_pad`` window is upscaled, and its centre is pasted.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", _conv(num_feat + i * num_grow, num_grow))
        self.conv5 = _conv(num_feat + 4 * num_grow, num_feat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(4):
            feats.append(F.leaky_relu(getattr(self, f"conv{i + 1}")(torch.cat(feats, 1)), 0.2))
        return x + 0.2 * self.conv5(torch.cat(feats, 1))


class RRDB(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow: int = 32):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = (ResidualDenseBlock(num_feat, num_grow) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """scale in {1, 2, 4}; (B, H, W, 3) in, (B, 4H/s', 4W/s', 3) out, where
    the unshuffle by s' = 4 / scale comes first."""

    def __init__(self, scale: int = 4, num_feat: int = 64, num_block: int = 23, num_grow: int = 32,
                 num_in_ch: int = 3, num_out_ch: int = 3):
        super().__init__()
        if scale not in (1, 2, 4):
            raise ValueError(f"RRDBNet scale {scale}: one of 1, 2, 4")
        self.scale = scale
        self.conv_first = _conv(num_in_ch * (16 if scale == 1 else 4 if scale == 2 else 1), num_feat)
        self.body = nn.Sequential(*(RRDB(num_feat, num_grow) for _ in range(num_block)))
        self.conv_body = _conv(num_feat, num_feat)
        self.conv_up1, self.conv_up2, self.conv_hr = (_conv(num_feat, num_feat) for _ in range(3))
        self.conv_last = _conv(num_feat, num_out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.scale < 4:
            x = F.pixel_unshuffle(x, 4 // self.scale)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        for conv in (self.conv_up1, self.conv_up2):
            feat = F.leaky_relu(conv(F.interpolate(feat, scale_factor=2, mode="nearest")), 0.2)
        out = self.conv_last(F.leaky_relu(self.conv_hr(feat), 0.2))
        return out.permute(0, 2, 3, 1)


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """numpy's ``reflect`` padding of an axis of length n as an index."""
    return torch.from_numpy(np.pad(np.arange(n), (lo, hi), mode="reflect")).to(device)


def tile_process(model: Callable[[torch.Tensor], torch.Tensor], img: torch.Tensor, scale: int,
                 tile_size: int = 400, tile_pad: int = 10) -> torch.Tensor:
    """(B, H, W, C) -> (B, H * scale, W * scale, 3), ``model`` applied to each
    context-padded tile."""
    b, h, w, c = img.shape
    th, tw = -(-h // tile_size), -(-w // tile_size)
    padded = img.index_select(1, _reflect_index(h, tile_pad, tile_pad + th * tile_size - h, img.device))
    padded = padded.index_select(2, _reflect_index(w, tile_pad, tile_pad + tw * tile_size - w, img.device))
    ext, inner, p = tile_size + 2 * tile_pad, tile_size * scale, tile_pad * scale
    out = None
    for i in range(th):
        for j in range(tw):
            y, x = i * tile_size, j * tile_size
            up = model(padded[:, y:y + ext, x:x + ext])
            if out is None:
                out = torch.zeros(b, th * inner, tw * inner, 3, dtype=up.dtype, device=up.device)
            out[:, y * scale:y * scale + inner, x * scale:x * scale + inner] = up[:, p:p + inner, p:p + inner]
    return out[:, :h * scale, :w * scale]
