"""Generate a pre-degraded LQ test set from a folder of HQ images, the port
of the root ``tools/lq.py``.

    python -m instarevive_tpu_torch.tools.lq --input <HQ dir> --output <LQ dir> [--seed 0] [--device cuda|cpu]

Per image, all on the device: an isotropic or anisotropic Gaussian blur on
the 41 x 41 grid (sigma in [0.1, 10]) through ``ops/filters.filter2d`` (K6 on
the card), a bilinear downsample by a scale drawn in [2, 4], Gaussian noise,
JPEG at a quality drawn in [60, 100] (``ops/diffjpeg``, on an edge-padded
copy whose sides are multiples of 16), and a bilinear resize back. Scale and
quality come from ``numpy.random.default_rng(seed)`` as in the JAX tool; the
kernel's and the noise's draws from ``torch.Generator``s seeded by
``seed * 100003 + i`` (the JAX tool's per-image key), or handed in
(``LQDraws``). The noise range is the JAX tool's ``(0, 20/255)`` in the
units ``generate_gaussian_noise`` divides by 255 (ROADMAP C17).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from instarevive_tpu_torch.ops.degradation import (
    Generators, KernelConfig, MixedKernelDraws, draw_mixed_kernel, generate_gaussian_noise, make_generators,
    random_mixed_kernel, uniform,
)

KERNEL_CFG = KernelConfig(kernel_list=("iso", "aniso"), kernel_prob=(0.5, 0.5), sinc_prob=0.0,
                          blur_sigma=(0.1, 10.0), kernel_range=(41,), pad_to=41)
NOISE_SIGMA = (0.0, 20.0 / 255.0)


@dataclass
class LQDraws:
    """One image's draws: the mixed kernel's, the noise sigma (1,), and the
    noise's two standard-normal fields (None: drawn on the device)."""

    kernel: MixedKernelDraws
    sigma: torch.Tensor
    fields: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def draw_lq(gens: Generators) -> LQDraws:
    return LQDraws(kernel=draw_mixed_kernel(gens.host, KERNEL_CFG, 1), sigma=uniform(gens.host, *NOISE_SIGMA, 1))


def lq_size(h: int, w: int, scale: float) -> Tuple[int, int]:
    return max(int(h // scale), 16), max(int(w // scale), 16)


def blur_down_noise(img: torch.Tensor, lhw: Tuple[int, int], draws: LQDraws,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(1, H, W, 3) [0, 1] -> the blurred, downsampled, noised (1, lh, lw, 3),
    clipped to [0, 1]."""
    from instarevive_tpu_torch.ops.filters import filter2d
    from instarevive_tpu_torch.ops.resize import interpolate

    kernel = random_mixed_kernel(draws.kernel, KERNEL_CFG, 41, img.device)
    x = interpolate(filter2d(img, kernel.contiguous()), lhw, mode="bilinear")
    gray = torch.zeros(1)
    return (x + generate_gaussian_noise(gen, x, draws.sigma, gray, draws.fields)).clamp(0.0, 1.0)


def jpeg_up(x: torch.Tensor, hw: Tuple[int, int], quality: float) -> torch.Tensor:
    """JPEG at ``quality`` on the edge-padded image, then bilinear back to
    ``hw``, clipped to [0, 1]."""
    from instarevive_tpu_torch.ops.diffjpeg import jpeg_compress_decompress
    from instarevive_tpu_torch.ops.resize import interpolate

    lh, lw = x.shape[1:3]
    ph, pw = -(-lh // 16) * 16, -(-lw // 16) * 16
    xp = F.pad(x.permute(0, 3, 1, 2), (0, pw - lw, 0, ph - lh), mode="replicate").permute(0, 2, 3, 1)
    xp = jpeg_compress_decompress(xp, quality, differentiable=False)
    return interpolate(xp[:, :lh, :lw].contiguous(), hw, mode="bilinear").clamp(0.0, 1.0)


def degrade(img: torch.Tensor, lhw: Tuple[int, int], quality: float, draws: LQDraws,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """One image (1, H, W, 3) in [0, 1] -> its LQ version, same shape."""
    return jpeg_up(blur_down_noise(img, lhw, draws, gen), img.shape[1:3], quality)


def main(argv=None, draws=None) -> list:
    """Returns the paths written. ``draws(i, lhw)``, when given, makes image
    ``i``'s ``LQDraws`` (the tests hand in the JAX tool's)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="HQ image folder")
    p.add_argument("--output", required=True, help="LQ output folder")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from PIL import Image

    from instarevive_tpu_torch.models.t5 import resolve_device
    from instarevive_tpu_torch.utils.image_io import list_image_files

    device = resolve_device(args.device)
    files = list_image_files(args.input)
    os.makedirs(args.output, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    written = []
    with torch.inference_mode():
        for i, f in enumerate(files):
            img = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
            scale = float(rng.uniform(2.0, 4.0))
            quality = float(rng.uniform(60.0, 100.0))
            h, w = img.shape[:2]
            lhw = lq_size(h, w, scale)
            gens = make_generators(args.seed * 100003 + i, device)
            out = degrade(torch.from_numpy(img)[None].to(device), lhw, quality,
                          draw_lq(gens) if draws is None else draws(i, lhw), gens.device)
            arr = torch.round(out[0] * 255.0).to(torch.uint8).cpu().numpy()
            path = os.path.join(args.output, os.path.basename(f))
            Image.fromarray(arr).save(path)
            written.append(path)
            print(f"{f} -> lq (scale {scale:.2f}, q {quality:.0f})")
    return written


if __name__ == "__main__":
    main()
