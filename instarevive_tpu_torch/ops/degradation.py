"""Real-ESRGAN-style degradation pieces, batched and on the image's device
(``instarevive_tpu/ops/degradation.py``): the blur-kernel families and their
samplers, Gaussian and Poisson noise.

Variable kernel sizes are a centre mask on the maximal ``pad_to`` grid, which
equals synthesising at size k and zero-padding. Every kernel function takes
its parameters as numbers or as tensors that broadcast, ``(B,)`` parameters
giving ``(B, K, K)`` kernels (the JAX package maps a scalar function over a
batch of keys instead).

Randomness. What a function draws comes from explicit ``torch.Generator``s
or is handed in. ``Generators`` pairs a CPU generator, for the per-batch
decisions and the per-sample parameters (a branch taken on a value that lives
on the device would make the host wait for the device), with a generator on
the image's device for the per-pixel fields. Each sampler accepts a ``draws``
object holding what it would have drawn, so that a test can hand this package
and the JAX package the same numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from instarevive_tpu_torch.ops.color import constant


class Generators(NamedTuple):
    host: torch.Generator    # CPU: decisions, scalars, per-sample parameters
    device: torch.Generator  # on the images' device: per-pixel fields


def make_generators(seed: int, device) -> Generators:
    return Generators(torch.Generator().manual_seed(seed), torch.Generator(device=device).manual_seed(seed))


def uniform(gen: torch.Generator, low: float, high: float, n: Optional[int] = None):
    """A float (n is None) or an (n,) f32 CPU tensor, uniform in [low, high)."""
    u = torch.rand(() if n is None else (n,), generator=gen) * (high - low) + low
    return float(u) if n is None else u


def choice(gen: torch.Generator, probs: Sequence[float], n: Optional[int] = None):
    """Index drawn with the given weights: an int, or an (n,) int64 CPU tensor."""
    idx = torch.multinomial(torch.tensor(probs, dtype=torch.float32), n or 1, replacement=True, generator=gen)
    return int(idx[0]) if n is None else idx


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def bessel_j1(x: torch.Tensor) -> torch.Tensor:
    """Bessel function of the first kind, order 1 (|err| < ~1e-7), by the
    Abramowitz-Stegun rational approximations."""
    ax = x.abs()
    y = x * x
    p1 = x * (
        72362614232.0
        + y * (-7895059235.0 + y * (242396853.1 + y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606)))))
    )
    q1 = 144725228442.0 + y * (2300535178.0 + y * (18583304.74 + y * (99447.43394 + y * (376.9991397 + y))))
    small = p1 / q1
    axs = ax.clamp_min(1e-20)
    z = 8.0 / axs
    y2 = z * z
    p2 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4 + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    q2 = 0.04687499995 + y2 * (
        -0.2002690873e-3 + y2 * (0.8449199096e-5 + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6))
    )
    xx = axs - 2.356194491
    large = torch.sqrt(0.636619772 / axs) * (torch.cos(xx) * p2 - z * torch.sin(xx) * q2)
    large = torch.where(x < 0, -large, large)
    return torch.where(ax < 8.0, small, large)


def _offsets(kernel_size: int, device) -> torch.Tensor:
    return torch.arange(-(kernel_size // 2), kernel_size // 2 + 1, dtype=torch.float32, device=device)


def _center_mask(kernel_size: int, active_size, device) -> torch.Tensor:
    """1 inside the central active_size x active_size square, else 0: (..., K, K)."""
    half = (_f32(active_size, device) - 1.0) / 2.0
    ax = (torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2.0).abs()
    m1d = (ax <= half[..., None] + 1e-6).float()
    return m1d[..., :, None] * m1d[..., None, :]


def _quad_form(kernel_size: int, sig_x, sig_y, theta, isotropic: bool) -> torch.Tensor:
    """q(v) = v^T Sigma^-1 v on the (K, K) grid of (x, y) offsets, Sigma the
    rotated covariance R diag(sx^2, sy^2) R^T: (..., K, K)."""
    sig_x = _f32(sig_x)
    device = sig_x.device
    sig_y = sig_x if isotropic else _f32(sig_y, device)
    theta = torch.zeros_like(sig_x) if isotropic else _f32(theta, device)
    ct, st = torch.cos(theta), torch.sin(theta)
    ix, iy = 1.0 / (sig_x**2), 1.0 / (sig_y**2)
    a = (ct * ct * ix + st * st * iy)[..., None, None]
    c = (st * st * ix + ct * ct * iy)[..., None, None]
    b = (ct * st * (ix - iy))[..., None, None]
    off = _offsets(kernel_size, device)
    x, y = off[None, :], off[:, None]  # x varies along columns, y along rows
    return a * x * x + 2.0 * b * x * y + c * y * y


def _finish(kernel: torch.Tensor, kernel_size: int, active_size) -> torch.Tensor:
    if active_size is not None:
        kernel = kernel * _center_mask(kernel_size, active_size, kernel.device)
    return kernel / kernel.sum(dim=(-2, -1), keepdim=True)


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, isotropic=True, active_size=None):
    q = _quad_form(kernel_size, sig_x, sig_x if sig_y is None else sig_y, theta, isotropic)
    return _finish(torch.exp(-0.5 * q), kernel_size, active_size)


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta, isotropic=True, active_size=None):
    q = _quad_form(kernel_size, sig_x, sig_y, theta, isotropic).clamp_min(0.0)
    beta = _f32(beta, q.device)[..., None, None]
    return _finish(torch.exp(-0.5 * torch.pow(q, beta)), kernel_size, active_size)


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, isotropic=True, active_size=None):
    q = _quad_form(kernel_size, sig_x, sig_y, theta, isotropic).clamp_min(0.0)
    beta = _f32(beta, q.device)[..., None, None]
    return _finish(1.0 / (torch.pow(q, beta) + 1.0), kernel_size, active_size)


def circular_lowpass_kernel(cutoff, kernel_size: int, active_size=None) -> torch.Tensor:
    """2-D sinc filter, cutoff in radians: (..., K, K)."""
    cutoff = _f32(cutoff)
    off = torch.arange(kernel_size, dtype=torch.float32, device=cutoff.device) - (kernel_size - 1) / 2.0
    r = torch.sqrt(off[:, None] ** 2 + off[None, :] ** 2)
    safe_r = r.clamp_min(1e-10)
    cut = cutoff[..., None, None]
    kernel = cut * bessel_j1(cut * safe_r) / (2.0 * math.pi * safe_r)
    kernel = torch.where(r < 1e-8, cut**2 / (4.0 * math.pi), kernel)
    return _finish(kernel, kernel_size, active_size)


def pulse_kernel(kernel_size: int, device=None) -> torch.Tensor:
    k = torch.zeros((kernel_size, kernel_size), dtype=torch.float32, device=device)
    k[kernel_size // 2, kernel_size // 2] = 1.0
    return k


# ---------------------------------------------------------------------------
# Random kernel sampling

KERNEL_TYPES = ("iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso", "plateau_aniso")


@dataclass(frozen=True)
class KernelConfig:
    """One blur-kernel sampling stage (the fields of the Real-ESRGAN training YAML)."""

    kernel_list: Sequence[str] = KERNEL_TYPES
    kernel_prob: Sequence[float] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03)
    sinc_prob: float = 0.1
    blur_sigma: Tuple[float, float] = (0.2, 3.0)
    betag_range: Tuple[float, float] = (0.5, 4.0)
    betap_range: Tuple[float, float] = (1.0, 2.0)
    rotation_range: Tuple[float, float] = (-math.pi, math.pi)
    kernel_range: Sequence[int] = tuple(2 * v + 1 for v in range(3, 11))  # 7..21
    pad_to: int = 21


@dataclass
class MixedKernelDraws:
    """What ``random_mixed_kernel`` draws, each (B,): the family as an index
    into ``KERNEL_TYPES``, the two sigmas, the rotation, the two betas."""

    ktype: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    theta: torch.Tensor
    betag: torch.Tensor
    betap: torch.Tensor


@dataclass
class StageKernelDraws:
    """What ``sample_stage_kernel`` draws, each (B,): the kernel size, the
    sinc cutoff, whether the sinc is taken, and the mixed kernel's draws."""

    size: torch.Tensor
    cutoff: torch.Tensor
    use_sinc: torch.Tensor
    mixed: MixedKernelDraws


@dataclass
class FinalSincDraws:
    size: torch.Tensor
    cutoff: torch.Tensor
    use_sinc: torch.Tensor


def _draw_beta(gen: torch.Generator, lo: float, hi: float, n: int) -> torch.Tensor:
    """Below and above 1 with equal probability."""
    low, high = uniform(gen, lo, 1.0, n), uniform(gen, 1.0, hi, n)
    return torch.where(torch.rand(n, generator=gen) < 0.5, low, high)


def family_probs(cfg: KernelConfig) -> list:
    probs = [0.0] * len(KERNEL_TYPES)
    for name, p in zip(cfg.kernel_list, cfg.kernel_prob):
        probs[KERNEL_TYPES.index(name)] = p
    return [p / sum(probs) for p in probs]


def draw_mixed_kernel(gen: torch.Generator, cfg: KernelConfig, n: int) -> MixedKernelDraws:
    return MixedKernelDraws(
        ktype=choice(gen, family_probs(cfg), n),
        sx=uniform(gen, *cfg.blur_sigma, n), sy=uniform(gen, *cfg.blur_sigma, n),
        theta=uniform(gen, *cfg.rotation_range, n),
        betag=_draw_beta(gen, *cfg.betag_range, n), betap=_draw_beta(gen, *cfg.betap_range, n),
    )


def _draw_size(gen: torch.Generator, cfg: KernelConfig, n: int) -> torch.Tensor:
    sizes = torch.tensor(list(cfg.kernel_range), dtype=torch.int64)
    return sizes[torch.randint(0, len(sizes), (n,), generator=gen)]


def draw_stage_kernel(gen: torch.Generator, cfg: KernelConfig, n: int) -> StageKernelDraws:
    """Kernel size from ``kernel_range``; the sinc cutoff's range depends on
    the size (< 13 -> [pi/3, pi], else [pi/5, pi])."""
    size = _draw_size(gen, cfg, n)
    lo = torch.where(size < 13, math.pi / 3.0, math.pi / 5.0)
    cutoff = torch.rand(n, generator=gen) * (math.pi - lo) + lo
    return StageKernelDraws(size=size, cutoff=cutoff, use_sinc=torch.rand(n, generator=gen) < cfg.sinc_prob,
                            mixed=draw_mixed_kernel(gen, cfg, n))


def draw_final_sinc_kernel(gen: torch.Generator, cfg: KernelConfig, final_sinc_prob: float, n: int) -> FinalSincDraws:
    return FinalSincDraws(size=_draw_size(gen, cfg, n), cutoff=uniform(gen, math.pi / 3.0, math.pi, n),
                          use_sinc=torch.rand(n, generator=gen) < final_sinc_prob)


def random_mixed_kernel(draws: MixedKernelDraws, cfg: KernelConfig, active_size, device=None) -> torch.Tensor:
    """(B, pad_to, pad_to) mixed blur kernels on ``device`` from their draws.
    All six families are evaluated on the small grid and each sample's is
    selected, so no branch depends on a drawn value."""
    sx, sy, theta, betag, betap = (_f32(t, device) for t in (draws.sx, draws.sy, draws.theta, draws.betag, draws.betap))
    if not isinstance(active_size, (int, float)):
        active_size = _f32(active_size, device)
    p = cfg.pad_to
    kernels = torch.stack([
        bivariate_gaussian(p, sx, sy, theta, isotropic=True, active_size=active_size),
        bivariate_gaussian(p, sx, sy, theta, isotropic=False, active_size=active_size),
        bivariate_generalized_gaussian(p, sx, sy, theta, betag, True, active_size),
        bivariate_generalized_gaussian(p, sx, sy, theta, betag, False, active_size),
        bivariate_plateau(p, sx, sy, theta, betap, True, active_size),
        bivariate_plateau(p, sx, sy, theta, betap, False, active_size),
    ])  # (6, B, K, K)
    ktype = draws.ktype.to(device=kernels.device, dtype=torch.int64)
    return kernels.gather(0, ktype[None, :, None, None].expand(1, -1, p, p))[0]


def sample_stage_kernel(draws: StageKernelDraws, cfg: KernelConfig, device=None) -> torch.Tensor:
    """One degradation-stage kernel per sample: the sinc where drawn, else mixed."""
    size = _f32(draws.size, device)
    sinc = circular_lowpass_kernel(_f32(draws.cutoff, device), cfg.pad_to, active_size=size)
    mixed = random_mixed_kernel(draws.mixed, cfg, size, device)
    return torch.where(draws.use_sinc.to(sinc.device)[:, None, None], sinc, mixed)


def sample_final_sinc_kernel(draws: FinalSincDraws, cfg: KernelConfig, device=None) -> torch.Tensor:
    """Final-stage kernel per sample: a sinc where drawn, else the identity pulse."""
    sinc = circular_lowpass_kernel(_f32(draws.cutoff, device), cfg.pad_to, active_size=_f32(draws.size, device))
    return torch.where(draws.use_sinc.to(sinc.device)[:, None, None], sinc, pulse_kernel(cfg.pad_to, sinc.device))


# ---------------------------------------------------------------------------
# Noise


def _luma(img: torch.Tensor) -> torch.Tensor:
    """torchvision rgb_to_grayscale weights, NHWC -> NHW1."""
    return (img @ constant((0.2989, 0.587, 0.114), img.device).to(img.dtype))[..., None]


def _per_sample(v, img: torch.Tensor) -> torch.Tensor:
    return _f32(v, img.device).reshape(img.shape[0], 1, 1, 1)


def generate_gaussian_noise(generator: Optional[torch.Generator], img: torch.Tensor, sigma, gray,
                            fields: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """sigma in [0, 255] units per sample (B,); gray per sample in {0, 1} (B,).
    ``fields`` = (standard normal of img's shape, standard normal of shape
    (B, H, W, 1)), drawn from ``generator`` (on img's device) unless given."""
    if fields is None:
        fields = (torch.randn(img.shape, generator=generator, device=img.device),
                  torch.randn((*img.shape[:3], 1), generator=generator, device=img.device))
    sigma = _per_sample(sigma, img) / 255.0
    gray = _per_sample(gray, img)
    return fields[0] * sigma * (1.0 - gray) + fields[1] * sigma * gray


def _quantise(img: torch.Tensor) -> torch.Tensor:
    return torch.round(img * 255.0).clamp(0, 255) / 255.0


def _count_unique_vals(img: torch.Tensor) -> torch.Tensor:
    """Per-sample count of distinct 8-bit levels, as 2^ceil(log2(n)): a
    (B, 256) presence table filled by one scatter, on the image's device."""
    b = img.shape[0]
    q = torch.round(img * 255.0).clamp(0, 255).long().reshape(b, -1)
    present = torch.zeros((b, 256), dtype=torch.float32, device=img.device)
    present.scatter_(1, q, 1.0)
    return torch.exp2(torch.ceil(torch.log2(present.sum(dim=-1))))


def generate_poisson_noise(generator: Optional[torch.Generator], img: torch.Tensor, scale, gray,
                           draw: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Shot noise: the image quantised to 8 bits, scaled to its number of
    levels, drawn as Poisson rates; ``draw`` maps the flat rates (colour
    field, then gray field) to their draws and defaults to ``torch.poisson``
    from ``generator``."""
    b = img.shape[0]
    imgq = _quantise(img)
    vals = _count_unique_vals(imgq).reshape(b, 1, 1, 1)
    gray_img = _quantise(_luma(img))
    gvals = _count_unique_vals(gray_img).reshape(b, 1, 1, 1)
    lam = torch.cat([(imgq * vals).reshape(-1), (gray_img * gvals).reshape(-1)])
    drawn = (draw(lam) if draw is not None else torch.poisson(lam, generator=generator)).float()
    noise = drawn[: imgq.numel()].reshape(imgq.shape) / vals - imgq
    gnoise = drawn[imgq.numel():].reshape(gray_img.shape) / gvals - gray_img
    gray = _per_sample(gray, img)
    return (noise * (1.0 - gray) + gnoise * gray) * _per_sample(scale, img)


def random_add_gaussian_noise(gens: Generators, img: torch.Tensor, sigma_range: Tuple[float, float],
                              gray_prob: float, clip: bool = True) -> torch.Tensor:
    b = img.shape[0]
    sigma = uniform(gens.host, *sigma_range, b)
    gray = (torch.rand(b, generator=gens.host) < gray_prob).float()
    out = img + generate_gaussian_noise(gens.device, img, sigma, gray)
    return out.clamp(0.0, 1.0) if clip else out


def random_add_poisson_noise(gens: Generators, img: torch.Tensor, scale_range: Tuple[float, float],
                             gray_prob: float, clip: bool = True) -> torch.Tensor:
    b = img.shape[0]
    scale = uniform(gens.host, *scale_range, b)
    gray = (torch.rand(b, generator=gens.host) < gray_prob).float()
    out = img + generate_poisson_noise(gens.device, img, scale, gray)
    return out.clamp(0.0, 1.0) if clip else out
