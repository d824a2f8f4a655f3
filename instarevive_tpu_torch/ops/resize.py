"""Separable resizers on NHWC tensors (``instarevive_tpu/ops/resize.py``):
torch-style ``interpolate`` (nearest, bilinear, bicubic, area, antialiased,
``align_corners``), the MATLAB and PIL bicubic conventions, and
``scale_and_translate`` with the weight-matrix semantics of
``jax.image.scale_and_translate``, which the degradation programs use to
resize inside a fixed canvas.

``interpolate`` and ``imresize_matlab`` compute their tap indices and weights
with numpy for the (in, out) size pair and apply them as a gather over the
few contributing taps and a small einsum, so the arithmetic is the JAX
package's term for term. ``scale_and_translate`` builds a dense
(in, out) weight matrix per axis on the tensor's device and applies the two
as matrix products.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    w = ((a + 2) * ax3 - (a + 3) * ax2 + 1) * (ax <= 1)
    return w + (a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a) * ((ax > 1) & (ax < 2))


def _linear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _kernel_fn(kernel: str, a: float):
    if kernel == "cubic":
        return partial(_cubic, a=a), 4.0
    if kernel == "linear":
        return _linear, 2.0
    raise ValueError(f"unknown kernel {kernel!r}")


def _apply_boundary(indices: np.ndarray, weights: np.ndarray, in_len: int, boundary: str):
    """Resolve out-of-range tap indices: 'replicate' clamps to the edge (torch
    without antialiasing), 'symmetric' mirrors with edge repeat (MATLAB
    imresize), 'renorm' drops out-of-range taps and renormalises (PIL, torch
    with antialiasing)."""
    if boundary == "replicate":
        indices = np.clip(indices, 0, in_len - 1)
    elif boundary == "symmetric":
        m = 2 * in_len
        j = np.mod(indices, m)
        indices = np.where(j < in_len, j, m - 1 - j)
    elif boundary == "renorm":
        valid = (indices >= 0) & (indices < in_len)
        weights = weights * valid
        weights = weights / np.sum(weights, axis=1, keepdims=True)
        indices = np.clip(indices, 0, in_len - 1)
    else:
        raise ValueError(boundary)
    return indices.astype(np.int64), weights


def _trim(indices: np.ndarray, weights: np.ndarray):
    """Drop the taps that are zero for every output pixel."""
    nz = np.nonzero(np.any(weights != 0, axis=0))[0]
    if len(nz):
        indices, weights = indices[:, nz[0]: nz[-1] + 1], weights[:, nz[0]: nz[-1] + 1]
    return indices, weights.astype(np.float32)


def _taps(u: np.ndarray, first: np.ndarray, kscale: float, kfn, width: float):
    p = int(np.ceil(width)) + 2
    indices = first[:, None] + np.arange(p)[None, :]
    weights = kscale * kfn((u[:, None] - indices) * kscale)
    return indices, weights / np.sum(weights, axis=1, keepdims=True)


@lru_cache(maxsize=64)
def _contributions(in_len: int, out_len: int, scale: float, kernel: str, antialias: bool, a: float,
                   boundary: str = "symmetric"):
    """MATLAB-convention tap indices and weights for one axis."""
    kfn, kwidth = _kernel_fn(kernel, a)
    kscale = scale if antialias and scale < 1.0 else 1.0
    width = kwidth / kscale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)  # output pixel x (1-based) samples the input at u
    indices, weights = _taps(u, np.floor(u - width / 2.0), kscale, kfn, width)
    return _trim(*_apply_boundary(indices - 1, weights, in_len, boundary))


@lru_cache(maxsize=64)
def _torch_contributions(in_len: int, out_len: int, kernel: str, antialias: bool, a: float,
                         align_corners: bool = False):
    """torch.nn.functional.interpolate convention."""
    kfn, kwidth = _kernel_fn(kernel, a)
    scale = out_len / in_len
    kscale = scale if antialias and scale < 1.0 else 1.0
    width = kwidth / kscale
    i = np.arange(out_len, dtype=np.float64)
    if align_corners:
        u = i * ((in_len - 1) / (out_len - 1)) if out_len > 1 else np.zeros_like(i)
    else:
        u = (i + 0.5) / scale - 0.5  # 0-based source coordinate
    indices, weights = _taps(u, np.floor(u - width / 2.0) + 1.0, kscale, kfn, width)
    # without antialiasing torch clamps coordinates; its antialiased path drops and renormalises
    return _trim(*_apply_boundary(indices, weights, in_len, "renorm" if antialias else "replicate"))


@lru_cache(maxsize=64)
def _box_contributions(in_len: int, out_len: int):
    """Adaptive average-pool taps (torch adaptive_avg_pool semantics)."""
    starts = (np.arange(out_len) * in_len) // out_len
    ends = -((-(np.arange(out_len) + 1) * in_len) // out_len)  # ceil
    indices = starts[:, None] + np.arange(int(np.max(ends - starts)))[None, :]
    weights = (indices < ends[:, None]).astype(np.float32)
    weights /= weights.sum(axis=1, keepdims=True)
    return np.clip(indices, 0, in_len - 1).astype(np.int64), weights


def _apply_taps(x: torch.Tensor, indices: np.ndarray, weights: np.ndarray, axis: int) -> torch.Tensor:
    """out[..., o, ...] = sum_p w[o, p] * x[..., idx[o, p], ...] along ``axis``."""
    out_len, p = indices.shape
    g = x.index_select(axis, torch.from_numpy(indices.reshape(-1)).to(x.device)).movedim(axis, -1)
    g = g.reshape(*g.shape[:-1], out_len, p)
    out = torch.einsum("...op,op->...o", g, torch.from_numpy(weights).to(device=x.device, dtype=g.dtype))
    return out.movedim(-1, axis)


def imresize_matlab(x: torch.Tensor, out_hw: Tuple[int, int], kernel: str = "cubic", antialias: bool = True,
                    spatial_axes: Tuple[int, int] = (-3, -2), boundary: str = "symmetric") -> torch.Tensor:
    """MATLAB ``imresize``-convention resize: cubic a=-0.5 with antialiasing
    on downscale and symmetric boundary. ``boundary='renorm'`` gives PIL
    ``Image.resize(..., BICUBIC)`` semantics."""
    ha, wa = (a % x.dim() for a in spatial_axes)
    xf = x.float()
    for axis, out_len in ((ha, out_hw[0]), (wa, out_hw[1])):
        in_len = x.shape[axis]
        if out_len != in_len:
            xf = _apply_taps(xf, *_contributions(in_len, out_len, out_len / in_len, kernel, antialias, -0.5, boundary),
                             axis)
    return xf.to(x.dtype)


def pil_resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int],
                       spatial_axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """PIL BICUBIC resize."""
    return imresize_matlab(x, out_hw, spatial_axes=spatial_axes, boundary="renorm")


def interpolate(x: torch.Tensor, out_hw: Optional[Tuple[int, int]] = None, scale_factor: Optional[float] = None,
                mode: str = "bilinear", antialias: bool = False, spatial_axes: Tuple[int, int] = (-3, -2),
                align_corners: bool = False) -> torch.Tensor:
    """torch ``F.interpolate`` semantics over the two ``spatial_axes`` (NHWC
    by default, ``(-2, -1)`` for NCHW). Modes: nearest | bilinear | bicubic |
    area."""
    if align_corners and mode not in ("bilinear", "bicubic"):
        raise ValueError("align_corners only applies to bilinear/bicubic")
    if align_corners and antialias:
        raise ValueError("align_corners is incompatible with antialias")
    ha, wa = (a % x.dim() for a in spatial_axes)
    in_h, in_w = x.shape[ha], x.shape[wa]
    if out_hw is None:
        if scale_factor is None:
            raise ValueError("need out_hw or scale_factor")
        out_hw = (int(in_h * scale_factor), int(in_w * scale_factor))
    out_h, out_w = out_hw
    if (out_h, out_w) == (in_h, in_w):
        return x

    if mode == "nearest":  # src = floor(dst * in / out)
        ih = np.minimum(np.arange(out_h) * in_h // out_h, in_h - 1)
        iw = np.minimum(np.arange(out_w) * in_w // out_w, in_w - 1)
        out = x.index_select(ha, torch.from_numpy(ih).to(x.device))
        return out.index_select(wa, torch.from_numpy(iw).to(x.device))

    if mode == "area":  # adaptive average pool
        xf = _apply_taps(x.float(), *_box_contributions(in_h, out_h), ha)
        return _apply_taps(xf, *_box_contributions(in_w, out_w), wa).to(x.dtype)

    kern = {"bilinear": "linear", "bicubic": "cubic"}[mode]
    a = -0.5 if antialias else -0.75  # torch's bicubic; its antialiased path is PIL's
    xf = x.float()
    for axis, in_len, out_len in ((ha, in_h, out_h), (wa, in_w, out_w)):
        if out_len != in_len:
            xf = _apply_taps(xf, *_torch_contributions(in_len, out_len, kern, antialias, a, align_corners), axis)
    return xf.to(x.dtype)


def resize_by_scale(x: torch.Tensor, scale: float, mode: str = "bicubic",
                    spatial_axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Scale-factor resize with torch's rounding of the output size."""
    ha, wa = spatial_axes
    out_hw = (int(x.shape[ha] * scale), int(x.shape[wa] * scale))
    if mode == "matlab_bicubic":
        return imresize_matlab(x, out_hw, spatial_axes=spatial_axes)
    return interpolate(x, out_hw, mode=mode, spatial_axes=spatial_axes)


# ------------------------------------------------------- scale_and_translate


def _triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    return (1.0 - x.abs()).clamp_min(0.0)


def _keys_cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, a = -0.5, for x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


_KERNELS = {"linear": _triangle_kernel, "cubic": _keys_cubic_kernel}


def weight_matrix(in_size: int, out_size: int, scale: float, translation: float, method: str, antialias: bool,
                  device=None) -> torch.Tensor:
    """The (in_size, out_size) f32 matrix of one axis: output sample o reads
    the input at ``(o + 0.5) / scale - translation / scale - 0.5`` through
    the method's kernel, widened by ``max(1 / scale, 1)`` when antialiased;
    columns sum to 1, and a column whose sample lies outside
    ``[-0.5, in_size - 0.5]`` is zero."""
    scale = torch.tensor(scale, dtype=torch.float32, device=device)
    translation = torch.tensor(translation, dtype=torch.float32, device=device)
    inv_scale = 1.0 / scale
    kernel_scale = inv_scale.clamp_min(1.0) if antialias else torch.ones_like(inv_scale)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale \
        - translation * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    weights = _KERNELS[method](x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def scale_and_translate(img: torch.Tensor, out_hw: Tuple[int, int], scale: Sequence[float],
                        translation: Sequence[float] = (0.0, 0.0), method: str = "linear",
                        antialias: bool = True) -> torch.Tensor:
    """Resize the (B, H, W, C) image into a (B, out_h, out_w, C) canvas by
    per-axis ``scale`` and ``translation`` (in output pixels), as
    ``jax.image.scale_and_translate`` does over the two spatial axes:
    methods 'linear' (triangle) and 'cubic' (Keys, a = -0.5), computed in
    f32 as two matrix products."""
    b, h, w, c = img.shape
    wh = weight_matrix(h, out_hw[0], scale[0], translation[0], method, antialias, img.device)
    ww = weight_matrix(w, out_hw[1], scale[1], translation[1], method, antialias, img.device)
    out = torch.einsum("bhwc,hH->bHwc", img.float(), wh)
    out = torch.einsum("bHwc,wW->bHWc", out, ww)
    return out.to(img.dtype).contiguous()  # the product may come back in another memory order
