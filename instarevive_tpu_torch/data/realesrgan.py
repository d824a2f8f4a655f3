"""Real-ESRGAN two-stage degradation as one batched program on the images'
device (``instarevive_tpu/data/realesrgan.py``): blur -> random resize ->
Gaussian or Poisson noise -> JPEG, twice, then {resize back + sinc, JPEG} in
random order and a bicubic resize back to the clean size. The blur kernels
are sampled here too.

The fixed canvas of the JAX package is kept: the working image lives in the
top-left of a canvas sized for the largest scale (``round16(1.5 h)`` after
stage 1, ``round16(h / 4 * 1.2)`` after stage 2), its virtual size a drawn
number; resizes are ``scale_and_translate`` with drawn scales into canvases
of fixed shape, and noise and JPEG run on the whole canvas. PyTorch could
work at the true sizes, but the results would part from the JAX package's at
the content's border, H and W would stop being multiples of 16 for the JPEG,
and every shape here stays the same from batch to batch.

What ``lax.cond`` and ``lax.switch`` choose there is a Python branch here, on
a value drawn from the CPU generator (``ops.degradation.Generators``), so the
host never waits for the device; only the noise fields come from the
device's generator. ``draw_degradation`` makes every host-side draw of one
call; ``degrade_batch`` takes them ready-made through ``draws``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from instarevive_tpu_torch.ops.degradation import (
    FinalSincDraws,
    Generators,
    KernelConfig,
    StageKernelDraws,
    choice,
    draw_final_sinc_kernel,
    draw_stage_kernel,
    generate_gaussian_noise,
    generate_poisson_noise,
    sample_final_sinc_kernel,
    sample_stage_kernel,
    uniform,
)
from instarevive_tpu_torch.ops.diffjpeg import jpeg_compress_decompress
from instarevive_tpu_torch.ops.filters import filter2d, usm_sharpen
from instarevive_tpu_torch.ops.resize import scale_and_translate


@dataclass(frozen=True)
class RealESRGANDegradationConfig:
    """The degradation fields of the Real-ESRGAN training configuration."""

    use_sharpener: bool = False
    resize_hq: bool = False
    # stage 1
    kernel1: KernelConfig = field(default_factory=lambda: KernelConfig(sinc_prob=0.1))
    resize_prob: Tuple[float, float, float] = (0.2, 0.7, 0.1)  # up, down, keep
    resize_range: Tuple[float, float] = (0.15, 1.5)
    gaussian_noise_prob: float = 0.5
    noise_range: Tuple[float, float] = (1.0, 30.0)
    poisson_scale_range: Tuple[float, float] = (0.05, 3.0)
    gray_noise_prob: float = 0.4
    jpeg_range: Tuple[float, float] = (30.0, 95.0)
    # stage 2
    second_blur_prob: float = 0.8
    kernel2: KernelConfig = field(default_factory=lambda: KernelConfig(sinc_prob=0.1))
    stage2_scale: Union[float, Tuple[float, float]] = 4.0
    resize_prob2: Tuple[float, float, float] = (0.3, 0.4, 0.3)
    resize_range2: Tuple[float, float] = (0.3, 1.2)
    gaussian_noise_prob2: float = 0.5
    noise_range2: Tuple[float, float] = (1.0, 25.0)
    poisson_scale_range2: Tuple[float, float] = (0.05, 2.5)
    gray_noise_prob2: float = 0.4
    jpeg_range2: Tuple[float, float] = (30.0, 95.0)
    final_sinc_prob: float = 0.8


@dataclass
class NoiseDraws:
    """One noise step: Gaussian when ``use_g`` else Poisson, with per-sample
    ``sigma``, ``pscale`` and ``gray`` (B,). ``fields`` (the two standard
    normal fields of ``generate_gaussian_noise``) and ``poisson`` (rates ->
    draws) stand in for the device generator when given."""

    use_g: bool
    sigma: torch.Tensor
    pscale: torch.Tensor
    gray: torch.Tensor
    fields: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    poisson: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@dataclass
class DegradeDraws:
    """Every host-side draw of one ``degrade_batch`` call. ``kernels`` are the
    three samplers' draws (unused when the kernels themselves are handed in)."""

    kernels: Optional[Tuple[StageKernelDraws, StageKernelDraws, FinalSincDraws]]
    s1: float
    mode1: int
    noise1: NoiseDraws
    q1: torch.Tensor
    blur2: bool
    stage2_scale: float
    s2: float
    mode2: int
    noise2: NoiseDraws
    q2: torch.Tensor
    mode3: int
    use_a: bool


def draw_batch_kernels(gen: torch.Generator, cfg: RealESRGANDegradationConfig, batch: int):
    return (draw_stage_kernel(gen, cfg.kernel1, batch), draw_stage_kernel(gen, cfg.kernel2, batch),
            draw_final_sinc_kernel(gen, cfg.kernel2, cfg.final_sinc_prob, batch))


def sample_batch_kernels(draws, cfg: RealESRGANDegradationConfig, device=None):
    """The per-sample kernel triple (stage 1, stage 2, final sinc), each
    (B, 21, 21) on ``device``, from ``draw_batch_kernels``' draws."""
    d1, d2, d3 = draws
    return (sample_stage_kernel(d1, cfg.kernel1, device), sample_stage_kernel(d2, cfg.kernel2, device),
            sample_final_sinc_kernel(d3, cfg.kernel2, device))


def _round16(x: float) -> int:
    return int(math.ceil(x / 16.0) * 16)


def _rand_scale(gen: torch.Generator, prob, rng_range) -> float:
    """up w.p. prob[0] (1..hi), down w.p. prob[1] (lo..1), keep otherwise."""
    which = choice(gen, [p / sum(prob) for p in prob])
    u = uniform(gen, 0.0, 1.0)
    return (1.0 + u * (rng_range[1] - 1.0), rng_range[0] + u * (1.0 - rng_range[0]), 1.0)[which]


def _draw_noise(gen: torch.Generator, b: int, g_prob, sigma_range, poisson_range, gray_prob) -> NoiseDraws:
    return NoiseDraws(
        use_g=uniform(gen, 0.0, 1.0) < g_prob, sigma=uniform(gen, *sigma_range, b),
        pscale=uniform(gen, *poisson_range, b), gray=(torch.rand(b, generator=gen) < gray_prob).float())


def draw_degradation(gen: torch.Generator, cfg: RealESRGANDegradationConfig, batch: int,
                     with_kernels: bool = True) -> DegradeDraws:
    """All host-side draws of one call, from the CPU generator ``gen``."""
    if isinstance(cfg.stage2_scale, (tuple, list)):
        stage2_scale = uniform(gen, *cfg.stage2_scale)
    else:
        stage2_scale = float(cfg.stage2_scale)
    return DegradeDraws(
        kernels=draw_batch_kernels(gen, cfg, batch) if with_kernels else None,
        s1=_rand_scale(gen, cfg.resize_prob, cfg.resize_range), mode1=int(torch.randint(0, 3, (), generator=gen)),
        noise1=_draw_noise(gen, batch, cfg.gaussian_noise_prob, cfg.noise_range, cfg.poisson_scale_range,
                           cfg.gray_noise_prob),
        q1=uniform(gen, *cfg.jpeg_range, batch),
        blur2=uniform(gen, 0.0, 1.0) < cfg.second_blur_prob, stage2_scale=stage2_scale,
        s2=_rand_scale(gen, cfg.resize_prob2, cfg.resize_range2), mode2=int(torch.randint(0, 3, (), generator=gen)),
        noise2=_draw_noise(gen, batch, cfg.gaussian_noise_prob2, cfg.noise_range2, cfg.poisson_scale_range2,
                           cfg.gray_noise_prob2),
        q2=uniform(gen, *cfg.jpeg_range2, batch), mode3=int(torch.randint(0, 3, (), generator=gen)),
        use_a=uniform(gen, 0.0, 1.0) < 0.5,
    )


_METHODS = ("linear", "linear", "cubic")  # area ~ antialiased linear, bilinear, bicubic


def _resize_traced(img: torch.Tensor, out_hw, src_hw, dst_hw, mode_idx: int) -> torch.Tensor:
    """Content of virtual size ``src_hw`` in the canvas's top-left -> content
    of virtual size ``dst_hw`` in an ``out_hw`` canvas; the sizes are f32
    numbers, ``mode_idx`` in {0: area as antialiased linear, 1: bilinear,
    2: bicubic}, all antialiased."""
    scale = [np.float32(dst_hw[0]) / np.float32(src_hw[0]), np.float32(dst_hw[1]) / np.float32(src_hw[1])]
    return scale_and_translate(img, out_hw, scale, (0.0, 0.0), method=_METHODS[mode_idx], antialias=True)


def _add_random_noise(generator: Optional[torch.Generator], img: torch.Tensor, d: NoiseDraws) -> torch.Tensor:
    """Exactly one of the two generators runs, as the drawn branch says."""
    if d.use_g:
        noise = generate_gaussian_noise(generator, img, d.sigma, d.gray, d.fields)
    else:
        noise = generate_poisson_noise(generator, img, d.pscale, d.gray, d.poisson)
    return (img + noise).clamp(0.0, 1.0)


@torch.no_grad()
def degrade_batch(gens: Optional[Generators], hq: torch.Tensor, cfg: RealESRGANDegradationConfig,
                  kernels: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                  draws: Optional[DegradeDraws] = None) -> Dict[str, torch.Tensor]:
    """The full two-stage synthesis. hq: (B, H, W, 3) in [0, 1]. Returns
    dict(hq in [-1, 1], lq in [0, 1] on 8-bit levels), both (B, H, W, 3).
    ``draws`` defaults to ``draw_degradation(gens.host, ...)``; ``gens`` may
    be None when the draws bring their own noise fields."""
    b, h, w, _ = hq.shape
    if draws is None:
        draws = draw_degradation(gens.host, cfg, b, with_kernels=kernels is None)
    if kernels is None:
        kernels = sample_batch_kernels(draws.kernels, cfg, hq.device)
    kernel1, kernel2, sinc_kernel = kernels
    field_gen = None if gens is None else gens.device
    f32 = np.float32

    hq_proc = usm_sharpen(hq) if cfg.use_sharpener else hq

    # ---- stage 1 ----
    out = filter2d(hq_proc, kernel1)
    s1 = f32(draws.s1)
    c1h, c1w = _round16(h * cfg.resize_range[1]), _round16(w * cfg.resize_range[1])
    vh1, vw1 = s1 * f32(h), s1 * f32(w)  # the virtual size
    out = _resize_traced(out, (c1h, c1w), (h, w), (vh1, vw1), draws.mode1)
    out = _add_random_noise(field_gen, out, draws.noise1)
    out = jpeg_compress_decompress(out.clamp(0, 1), draws.q1, differentiable=False)

    # ---- stage 2 ----
    if draws.blur2:
        out = filter2d(out, kernel2)
    stage2_scale = f32(draws.stage2_scale)
    min_div = cfg.stage2_scale[0] if isinstance(cfg.stage2_scale, (tuple, list)) else float(cfg.stage2_scale)
    t2h, t2w = vh1 / s1 / stage2_scale, vw1 / s1 / stage2_scale  # = h / s2, w / s2
    s2 = f32(draws.s2)
    c2h = _round16(h / min_div * cfg.resize_range2[1])
    c2w = _round16(w / min_div * cfg.resize_range2[1])
    out = _resize_traced(out, (c2h, c2w), (vh1, vw1), (t2h * s2, t2w * s2), draws.mode2)
    out = _add_random_noise(field_gen, out, draws.noise2)

    # ---- final: {resize back + sinc, JPEG} in random order, then back to the clean size
    def resize_back_sinc(img):
        r = _resize_traced(img, (c2h, c2w), (t2h * s2, t2w * s2), (t2h, t2w), draws.mode3)
        return filter2d(r, sinc_kernel)

    def jpeg(img):
        return jpeg_compress_decompress(img.clamp(0, 1), draws.q2, differentiable=False)

    out = jpeg(resize_back_sinc(out)) if draws.use_a else resize_back_sinc(jpeg(out))
    out = _resize_traced(out, (h, w), (t2h, t2w), (h, w), 2)  # bicubic
    lq = torch.round(out.clamp(0, 1) * 255.0).clamp(0, 255) / 255.0
    return {"hq": hq_proc * 2.0 - 1.0, "lq": lq}
