"""CodeFormer-style single-stage degradation on the images' device
(``instarevive_tpu/data/codeformer.py``): random mixed-kernel blur (41 taps)
-> bilinear downsample by a drawn factor in [4, 8] -> Gaussian noise -> JPEG
-> bilinear resize back, with the fixed canvas of ``data/realesrgan.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from instarevive_tpu_torch.data.realesrgan import _resize_traced, _round16
from instarevive_tpu_torch.ops.degradation import (
    Generators,
    KernelConfig,
    MixedKernelDraws,
    draw_mixed_kernel,
    generate_gaussian_noise,
    random_mixed_kernel,
    uniform,
)
from instarevive_tpu_torch.ops.diffjpeg import jpeg_compress_decompress
from instarevive_tpu_torch.ops.filters import filter2d


@dataclass(frozen=True)
class CodeformerDegradationConfig:
    blur_kernel_size: int = 41
    kernel: KernelConfig = field(
        default_factory=lambda: KernelConfig(
            kernel_list=("iso", "aniso"),
            kernel_prob=(0.5, 0.5),
            sinc_prob=0.0,
            blur_sigma=(0.1, 10.0),
            kernel_range=(41,),
            pad_to=41,
        )
    )
    downsample_range: Tuple[float, float] = (4.0, 8.0)
    noise_range: Tuple[float, float] = (0.0, 20.0)
    jpeg_range: Tuple[float, float] = (60.0, 100.0)


@dataclass
class CodeformerDraws:
    """Every host-side draw of one call; ``fields`` stands in for the device
    generator's two normal fields when given."""

    kernel: MixedKernelDraws
    scale: float
    sigma: torch.Tensor
    q: torch.Tensor
    fields: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def draw_codeformer(gen: torch.Generator, cfg: CodeformerDegradationConfig, batch: int) -> CodeformerDraws:
    return CodeformerDraws(kernel=draw_mixed_kernel(gen, cfg.kernel, batch), scale=uniform(gen, *cfg.downsample_range),
                           sigma=uniform(gen, *cfg.noise_range, batch), q=uniform(gen, *cfg.jpeg_range, batch))


@torch.no_grad()
def degrade_batch_codeformer(gens: Optional[Generators], hq: torch.Tensor, cfg: CodeformerDegradationConfig,
                             draws: Optional[CodeformerDraws] = None) -> Dict[str, torch.Tensor]:
    """hq (B, H, W, 3) in [0, 1] -> dict(hq in [-1, 1], lq in [0, 1]) at (H, W)."""
    b, h, w, _ = hq.shape
    if draws is None:
        draws = draw_codeformer(gens.host, cfg, b)
    kernels = random_mixed_kernel(draws.kernel, cfg.kernel, cfg.kernel.pad_to, hq.device)
    out = filter2d(hq, kernels)

    # downsample by the drawn factor (bilinear) inside the fixed canvas
    scale = np.float32(draws.scale)
    ch, cw = _round16(h / cfg.downsample_range[0]), _round16(w / cfg.downsample_range[0])
    vh, vw = np.float32(h) / scale, np.float32(w) / scale
    out = _resize_traced(out, (ch, cw), (h, w), (vh, vw), 1)

    noise = generate_gaussian_noise(None if gens is None else gens.device, out, draws.sigma,
                                    torch.zeros(b), draws.fields)
    out = jpeg_compress_decompress((out + noise).clamp(0, 1), draws.q, differentiable=False)
    out = _resize_traced(out, (h, w), (vh, vw), (h, w), 1)  # bilinear
    return {"hq": hq * 2.0 - 1.0, "lq": out.clamp(0.0, 1.0)}
