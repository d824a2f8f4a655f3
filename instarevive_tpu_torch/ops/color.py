"""Color fixes on NHWC images (``instarevive_tpu/ops/color.py``)."""

from __future__ import annotations

from functools import lru_cache

import torch

from instarevive_tpu_torch.ops.filters import depthwise_conv2d

_WAVELET_KERNEL = torch.tensor(
    [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125], [0.0625, 0.125, 0.0625]],
    dtype=torch.float32,
)


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """À-trous blur: 3x3 kernel dilated by ``radius``, replicate padding."""
    return depthwise_conv2d(image, _WAVELET_KERNEL, dilation=radius, pad_mode="edge")


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    """Split an NHWC image into (high_freq_sum, low_freq) over dyadic radii."""
    high_freq = torch.zeros_like(image)
    low_freq = image
    for i in range(levels):
        blurred = wavelet_blur(low_freq, 2**i)
        high_freq = high_freq + (low_freq - blurred)
        low_freq = blurred
    return high_freq, low_freq


def wavelet_color_fix(content: torch.Tensor, style: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Content high frequencies + style low frequencies."""
    content_high, _ = wavelet_decomposition(content, levels)
    _, style_low = wavelet_decomposition(style, levels)
    return content_high + style_low


def _mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """Per-sample per-channel spatial mean/std; unbiased variance."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    mean = flat.mean(dim=1)
    var = flat.var(dim=1, unbiased=True) + eps
    return mean.reshape(b, 1, 1, c), torch.sqrt(var).reshape(b, 1, 1, c)


def adain_color_fix(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Adaptive instance norm color transfer."""
    style_mean, style_std = _mean_std(style)
    content_mean, content_std = _mean_std(content)
    return (content - content_mean) / content_std * style_std + style_mean


_RGB2YCBCR_JPEG = ((0.299, -0.168736, 0.5), (0.587, -0.331264, -0.418688), (0.114, 0.5, -0.081312))
_YCBCR2RGB_JPEG = ((1.0, 1.0, 1.0), (0.0, -0.344136, 1.772), (1.402, -0.714136, 0.0))
_CHROMA_OFFSET = (0.0, 128.0, 128.0)


@lru_cache(maxsize=64)
def constant(values: tuple, device: torch.device) -> torch.Tensor:
    """``values`` (nested tuples of numbers) as an f32 tensor on ``device``,
    copied there once rather than from pageable memory on every call."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


def rgb_to_ycbcr(img: torch.Tensor) -> torch.Tensor:
    """JPEG full-range RGB->YCbCr (for DiffJPEG), NHWC in [0, 255]."""
    return img @ constant(_RGB2YCBCR_JPEG, img.device) + constant(_CHROMA_OFFSET, img.device)


def ycbcr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """JPEG full-range YCbCr->RGB, NHWC in [0, 255]."""
    return (img - constant(_CHROMA_OFFSET, img.device)) @ constant(_YCBCR2RGB_JPEG, img.device)


# BT.601 full-range to video-range, as basicsr's rgb2ycbcr (MATLAB's convention)
_RGB2YCBCR_MATLAB = ((65.481, -37.797, 112.0), (128.553, -74.203, -93.786), (24.966, 112.0, -18.214))
_YCBCR_MATLAB_BIAS = (16.0, 128.0, 128.0)


def rgb2ycbcr_matlab(img: torch.Tensor, y_only: bool = False) -> torch.Tensor:
    """MATLAB/basicsr rgb2ycbcr on [0, 1] NHWC input, output in [0, 1]; the Y
    channel alone (kept as a channel) with ``y_only``."""
    m = constant(_RGB2YCBCR_MATLAB, img.device)
    if y_only:
        out = (img @ m[:, 0] + 16.0)[..., None]
    else:
        out = img @ m + constant(_YCBCR_MATLAB_BIAS, img.device)
    return out / 255.0
