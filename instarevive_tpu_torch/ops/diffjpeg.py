"""Differentiable JPEG compression on NHWC images with per-sample quality
(``instarevive_tpu/ops/diffjpeg.py``).

The 8x8 DCT is two small matrix products with the separable DCT-II basis,
left to ``torch.einsum`` as the JAX package leaves them to XLA. Input and
output are NHWC in [0, 1]; H and W must be multiples of 16.
"""

from __future__ import annotations

import numpy as np
import torch

from instarevive_tpu_torch.ops.color import constant, rgb_to_ycbcr, ycbcr_to_rgb

# Standard JPEG base quantization tables (luma / chroma).
Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)

C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]])


def _dct_matrix() -> np.ndarray:
    """8-point DCT-II basis with JPEG scaling, (frequency, spatial)."""
    n = np.arange(8)
    m = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    alpha = np.full(8, np.sqrt(2.0 / 8.0))
    alpha[0] = np.sqrt(1.0 / 8.0)
    return (alpha[:, None] * m).astype(np.float32)


def _as_tuple(a: np.ndarray) -> tuple:
    return tuple(tuple(float(v) for v in row) for row in a)


_DCT, _Y, _C = _as_tuple(_dct_matrix()), _as_tuple(Y_TABLE), _as_tuple(C_TABLE)


def quality_to_factor(quality) -> torch.Tensor:
    """JPEG quality (1-100) -> quantization scale factor; quality 100 is
    clamped to the level of 99.5, where the factor would be 0."""
    quality = torch.as_tensor(quality, dtype=torch.float32)
    factor = torch.where(quality < 50.0, 5000.0 / quality, 200.0 - quality * 2.0)
    return (factor / 100.0).clamp_min(0.01)


def diff_round(x: torch.Tensor) -> torch.Tensor:
    """Differentiable rounding: round(x) + (x - round(x))^3."""
    r = torch.round(x)
    return r + (x - r) ** 3


def _blockify(plane: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, nb, 8, 8) in row-major 8x8 block order."""
    b, h, w = plane.shape
    return plane.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _unblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = blocks.shape[0]
    return blocks.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h, w)


def jpeg_compress_decompress(img: torch.Tensor, quality, differentiable: bool = True) -> torch.Tensor:
    """Round-trip JPEG on NHWC [0, 1] images; ``quality`` scalar or (B,)."""
    b, h, w, _ = img.shape
    if h % 16 or w % 16:
        raise ValueError(f"H,W must be multiples of 16, got {(h, w)}")
    rnd = diff_round if differentiable else torch.round
    factor = quality_to_factor(quality).to(img.device).reshape(-1, 1, 1, 1)
    if factor.shape[0] == 1 and b > 1:
        factor = factor.expand(b, 1, 1, 1)
    dct = constant(_DCT, img.device)

    ycbcr = rgb_to_ycbcr(img.float() * 255.0)
    y = ycbcr[..., 0]
    # 2x2 chroma subsampling (average pooling)
    cb = ycbcr[..., 1].reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    cr = ycbcr[..., 2].reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def roundtrip(plane, table, ph, pw):
        blocks = torch.einsum("ij,bnjk,lk->bnil", dct, _blockify(plane) - 128.0, dct)  # D (x - 128) D^T
        q = constant(table, img.device)[None, None] * factor
        coefs = rnd(blocks / q) * q
        return _unblockify(torch.einsum("ji,bnjk,kl->bnil", dct, coefs, dct) + 128.0, ph, pw)

    y = roundtrip(y, _Y, h, w)
    cb = roundtrip(cb, _C, h // 2, w // 2)
    cr = roundtrip(cr, _C, h // 2, w // 2)
    # chroma upsampling: nearest (repeat)
    cb = cb.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cr = cr.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    rgb = ycbcr_to_rgb(torch.stack([y, cb, cr], dim=-1))
    return (rgb / 255.0).clamp(0.0, 1.0).to(img.dtype)
