"""RAW/ISP processing (``instarevive_tpu/ops/isp.py``): RGGB bayer stack ->
RGB through gains, colour correction and a camera response function looked up
by batched linear interpolation.
"""

from __future__ import annotations

import torch


def interp1d(x_new: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched linear interpolation with ``numpy.interp``'s semantics: values
    outside the knots take the end values. x_new: (B, M); x: (B, N)
    ascending; y: (B, N) -> (B, M)."""
    n = x.shape[1]
    i = torch.searchsorted(x.contiguous(), x_new.contiguous(), right=True).clamp(1, n - 1)
    x0, x1 = torch.gather(x, 1, i - 1), torch.gather(x, 1, i)
    y0, y1 = torch.gather(y, 1, i - 1), torch.gather(y, 1, i)
    dx = x1 - x0
    flat = dx.abs() <= torch.finfo(x.dtype).eps
    out = torch.where(flat, y0, y0 + (x_new - x0) / torch.where(flat, torch.ones_like(dx), dx) * (y1 - y0))
    out = torch.where(x_new < x[:, :1], y[:, :1], out)
    return torch.where(x_new > x[:, -1:], y[:, -1:], out)


def apply_gains(bayer: torch.Tensor, red_gain: torch.Tensor, blue_gain: torch.Tensor) -> torch.Tensor:
    """Per-channel gains (B,) on an RGGB bayer stack (B, H, W, 4)."""
    one = torch.ones_like(red_gain)
    gains = torch.stack([red_gain, one, one, blue_gain], dim=-1)
    return bayer * gains[:, None, None, :]


def demosaic_bilinear(bayer: torch.Tensor) -> torch.Tensor:
    """RGGB stack (B, H, W, 4) -> RGB (B, H, W, 3) on the stack's half-res
    grid: green is the mean of the two green planes."""
    return torch.stack([bayer[..., 0], (bayer[..., 1] + bayer[..., 2]) / 2.0, bayer[..., 3]], dim=-1)


def apply_ccm(rgb: torch.Tensor, ccm: torch.Tensor) -> torch.Tensor:
    """Colour correction matrix per sample, (B, 3, 3)."""
    return torch.einsum("bhwc,bdc->bhwd", rgb, ccm)


def gamma_compression(rgb: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return rgb.clamp_min(1e-8) ** (1.0 / gamma)


def apply_crf(rgb: torch.Tensor, crf_i: torch.Tensor, crf_b: torch.Tensor) -> torch.Tensor:
    """Camera response function by interpolation: ``crf_i`` (N,) irradiance
    knots, ``crf_b`` (N,) brightness values."""
    flat = rgb.reshape(rgb.shape[0], -1)
    out = interp1d(flat, crf_i[None].expand(flat.shape[0], -1), crf_b[None].expand(flat.shape[0], -1))
    return out.reshape(rgb.shape)


def raw2rgb(bayer: torch.Tensor, red_gain, blue_gain, ccm: torch.Tensor, crf_i=None, crf_b=None,
            gamma: float = 2.2) -> torch.Tensor:
    """The whole pipeline: gains -> demosaic -> CCM -> CRF or gamma."""
    x = apply_gains(bayer, red_gain, blue_gain).clamp(0.0, 1.0)
    x = apply_ccm(demosaic_bilinear(x), ccm).clamp(0.0, 1.0)
    if crf_i is not None:
        return apply_crf(x, crf_i, crf_b)
    return gamma_compression(x, gamma)
