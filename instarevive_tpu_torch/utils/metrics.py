"""Image quality metrics on the device (``instarevive_tpu/utils/metrics.py``):
PSNR and SSIM with basicsr's conventions (``crop_border``, the Y channel of
MATLAB's YCbCr), and LPIPS: the ``lpips`` package's AlexNet-feature distance
(``LPIPS``), whose weights come from torchvision's AlexNet and the
``lpips`` checkpoint (``lpips_state_dict``) or from the JAX package's params
(``convert/from_jax.lpips_params_to_torch``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.convert.checkpoint_layouts import TakeKeys
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


class LPIPS(nn.Module):
    """LPIPS, ``alex`` variant: (B,) distances between two [-1, 1] NHWC
    batches. The AlexNet trunk's five ReLU'd convolutions (the first two
    followed by a 3x3 stride-2 max-pool), each unit-normalised over channels
    (eps outside the square root, as ``lpips.normalize_tensor``), squared
    differences weighted by ``lins[i]`` (1, C), averaged over the map and
    summed over the five. Plain torch ops (cuDNN's convolutions on the card)."""

    CONVS = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1), (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))
    ALEXNET_IDS = (0, 3, 6, 8, 10)  # the convolutions' places in torchvision's ``alexnet.features``

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, k, stride=s, padding=p) for ci, co, k, s, p in self.CONVS)
        self.lins = nn.ParameterList(nn.Parameter(torch.zeros(1, co)) for _, co, _, _, _ in self.CONVS)

    def features(self, x: torch.Tensor):
        shift = torch.tensor([-0.030, -0.088, -0.188], device=x.device, dtype=x.dtype).view(1, 3, 1, 1)
        scale = torch.tensor([0.458, 0.448, 0.450], device=x.device, dtype=x.dtype).view(1, 3, 1, 1)
        h = (x.permute(0, 3, 1, 2) - shift) / scale
        feats = []
        for i, conv in enumerate(self.convs):
            h = F.relu(conv(h))
            feats.append(h)
            if i < 2:
                h = F.max_pool2d(h, 3, 2)
        return feats

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        dist = 0.0
        for fa, fb, w in zip(self.features(pred), self.features(target), self.lins):
            fa = fa / (fa.square().sum(1, keepdim=True).sqrt() + 1e-10)
            fb = fb / (fb.square().sum(1, keepdim=True).sqrt() + 1e-10)
            dist = dist + ((fa - fb).square() * w[0].view(1, -1, 1, 1)).sum(1).mean(dim=(1, 2))
        return dist


def lpips_state_dict(alexnet_sd: Mapping, lpips_sd: Mapping) -> Dict[str, torch.Tensor]:
    """``LPIPS``'s state dict from torchvision's AlexNet state dict (its
    ``features`` convolutions; the ``classifier`` goes unused) and the
    ``lpips`` package's ``alex.pth`` (``lin{i}.model.1.weight``, (1, C, 1, 1))."""
    alex, lins = TakeKeys(alexnet_sd, "AlexNet"), TakeKeys(lpips_sd, "LPIPS")
    sd = {}
    for i, ci in enumerate(LPIPS.ALEXNET_IDS):
        for leaf in ("weight", "bias"):
            sd[f"convs.{i}.{leaf}"] = torch.as_tensor(alex.take(f"features.{ci}.{leaf}")).float()
        sd[f"lins.{i}"] = torch.as_tensor(lins.take(f"lin{i}.model.1.weight")).float()[:, :, 0, 0]
    alex.done(ignore=("classifier.",))
    lins.done()
    return sd
