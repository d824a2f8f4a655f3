"""Image quality metrics on the device (``instarevive_tpu/utils/metrics.py``):
PSNR and SSIM with basicsr's conventions (``crop_border``, the Y channel of
MATLAB's YCbCr). LPIPS waits for its weights.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from instarevive_tpu_torch.ops.color import rgb2ycbcr_matlab
from instarevive_tpu_torch.ops.filters import gaussian_kernel1d


def _prep(img: torch.Tensor, crop_border: int, test_y: bool) -> torch.Tensor:
    if test_y:
        img = rgb2ycbcr_matlab(img, y_only=True)
    if crop_border:
        img = img[:, crop_border:-crop_border, crop_border:-crop_border]
    return img


def psnr(img: torch.Tensor, img2: torch.Tensor, crop_border: int = 0, test_y_channel: bool = False) -> torch.Tensor:
    """(B,) PSNR in dB of two [0, 1] NHWC batches, in float64."""
    a = _prep(img.float(), crop_border, test_y_channel).double()
    b = _prep(img2.float(), crop_border, test_y_channel).double()
    mse = ((a - b) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def _ssim_single_channel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SSIM of (B, H, W) maps on the [0, 255] scale: 11x11 gaussian windows
    (sigma 1.5), valid positions only; (B,)."""
    k1 = gaussian_kernel1d(11, 1.5)
    window = torch.from_numpy(np.outer(k1, k1)).to(a.device)[None, None]
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2

    def f(x):
        return F.conv2d(x[:, None], window)[:, 0]

    mu1, mu2 = f(a), f(b)
    mu1s, mu2s, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = f(a * a) - mu1s
    s2 = f(b * b) - mu2s
    s12 = f(a * b) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1s + mu2s + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2))


def ssim(img: torch.Tensor, img2: torch.Tensor, crop_border: int = 0, test_y_channel: bool = False) -> torch.Tensor:
    """(B,) SSIM of two [0, 1] NHWC batches, the mean over channels, in
    float32 (basicsr's calculate_ssim)."""
    a = _prep(img.float(), crop_border, test_y_channel) * 255.0
    b = _prep(img2.float(), crop_border, test_y_channel) * 255.0
    return torch.stack([_ssim_single_channel(a[..., c], b[..., c]) for c in range(a.shape[-1])], dim=-1).mean(dim=-1)
