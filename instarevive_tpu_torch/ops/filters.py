"""Batched filtering on NHWC images (``instarevive_tpu/ops/filters.py``):
``filter2d`` (per-sample kernels, reflect padding), the depthwise
convolution, the separable Gaussian blur and USM sharpening.

``filter2d(img, kernel)`` correlates every channel of sample ``b`` with
``kernel[b]`` (or with one shared ``(kh, kw)`` kernel) over the reflect-padded
image, so the output has the input's shape:
``out[b, y, x, c] = sum_ij kernel[b, i, j] * pad(img)[b, y + i, x + j, c]``.
At ``dilation == 1`` it wraps ``csrc/filter2d.cu``, which replaces the TPU
kernel ``_filter2d_plane_kernel`` of ``instarevive_tpu/ops/filters.py``
(through ``_filter2d_pallas``). ``filter2d_plain`` beside it is the same
function as reflect ``F.pad`` and one grouped ``F.conv2d`` with the batch
folded into the channels. On a CPU tensor the wrapper runs the plain version;
on a CUDA tensor it launches the kernel or raises. A dilated filter never
reached the TPU kernel either and stays the grouped convolution, as do
``depthwise_conv2d``, ``gaussian_blur`` and ``usm_sharpen``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from instarevive_tpu_torch.ops.cuda_build import load_library
from instarevive_tpu_torch.ops.norm_kernels import raise_on_error

_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}
MAX_TAPS = 41            # the kernel's largest kh and kw
PLAN_FIELDS = ("e", "rows", "tiles", "smem", "blocks_per_sm", "sms")


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics: sigma <= 0 derives sigma from ksize."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_kernel2d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    k = gaussian_kernel1d(ksize, sigma)
    return np.outer(k, k).astype(np.float32)


def _check_filter(img: torch.Tensor, kernel: torch.Tensor) -> None:
    if img.dim() != 4 or img.numel() == 0:
        raise ValueError(f"filter2d: expected a non-empty (B, H, W, C) image, got shape {tuple(img.shape)}")
    if kernel.dim() not in (2, 3) or (kernel.dim() == 3 and kernel.shape[0] != img.shape[0]):
        raise ValueError(f"filter2d: the kernel must be (kh, kw) or (B, kh, kw) with B={img.shape[0]}, "
                         f"got {tuple(kernel.shape)}")


def filter2d_plain(img: torch.Tensor, kernel: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """``filter2d`` in PyTorch: reflect pad, then one grouped convolution
    over (1, B * C, H, W) with the kernel of sample b repeated for its C
    channels; f32 arithmetic, output in img's dtype."""
    _check_filter(img, kernel)
    b, h, w, c = img.shape
    if kernel.dim() == 2:
        kernel = kernel[None].expand(b, -1, -1)
    kh, kw = kernel.shape[-2:]
    ph, pw = ((kh - 1) * dilation + 1) // 2, ((kw - 1) * dilation + 1) // 2
    x = F.pad(img.permute(0, 3, 1, 2).float(), (pw, pw, ph, ph), mode="reflect")
    x = x.reshape(1, b * c, h + 2 * ph, w + 2 * pw)
    k = kernel.to(device=img.device, dtype=torch.float32).repeat_interleave(c, dim=0)[:, None]
    out = F.conv2d(x, k, dilation=dilation, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(img.dtype)


@lru_cache(maxsize=None)
def _kernel():
    lib = load_library("filter2d")
    lib.filter2d_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.filter2d_f32.restype = ctypes.c_int
    lib.filter2d_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.filter2d_plan.restype = ctypes.c_int
    return lib


def filter2d_plan(shape, taps, align: int = 16) -> dict:
    """The launch ``filter2d`` makes on the current card for a (B, H, W, C)
    image and (kh, kw) taps, with the image and the output ``align``-byte
    aligned, as its C launcher picks it (``filter2d_plan`` in
    ``csrc/filter2d.cu``): ``e`` channels a band, ``rows`` output rows a
    thread, ``tiles`` blocks (one a tile), ``smem`` bytes a block,
    ``blocks_per_sm`` resident, ``sms`` of the card."""
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    raise_on_error(_kernel().filter2d_plan(*shape, *taps, align, plan), "filter2d_plan")
    return dict(zip(PLAN_FIELDS, plan))


def filter2d(img: torch.Tensor, kernel: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Correlate NHWC ``img`` (B, H, W, C) with a per-sample (B, kh, kw) or a
    shared (kh, kw) kernel over the reflect-padded image; same shape out. On
    the card (``dilation == 1``): f32, contiguous, odd kh and kw up to 41 with
    ``kh // 2 < H`` and ``kw // 2 < W``; any H, W and C, one launch
    (``filter2d_plan`` says how it tiles)."""
    _check_filter(img, kernel)
    if not img.is_cuda or dilation != 1:
        return filter2d_plain(img, kernel, dilation)
    b, h, w, c = img.shape
    kh, kw = kernel.shape[-2:]
    for t, what in ((img, "image"), (kernel, "kernel")):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != img.device:
            raise ValueError(f"filter2d: the {what} must be a contiguous f32 tensor on {img.device}, got {t.dtype} "
                             f"with strides {t.stride()} on {t.device}")
        if t.requires_grad:
            raise RuntimeError(f"filter2d: the {what} requires grad and the kernel has no backward; "
                               "call it under torch.no_grad()")
    if kh % 2 == 0 or kw % 2 == 0 or max(kh, kw) > MAX_TAPS:
        raise ValueError(f"filter2d: the kernel takes odd sizes up to {MAX_TAPS}, got {kh} x {kw}")
    if kh // 2 >= h or kw // 2 >= w:
        raise ValueError(f"filter2d: reflect padding of {kh // 2} x {kw // 2} needs a larger image than {h} x {w}")
    if img.numel() >= 2**31:
        raise ValueError(f"filter2d: shape {tuple(img.shape)} is beyond the kernel's 32-bit index")
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        err = _kernel().filter2d_f32(img.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, h, w, c, kh, kw,
                                     int(kernel.dim() == 3), torch.cuda.current_stream().cuda_stream)
    raise_on_error(err, "filter2d")
    filter2d.launches += 1
    if filter2d.shapes is not None:
        key = (b, h, w, c, kh, kw, kernel.dim() == 3)
        filter2d.shapes[key] = filter2d.shapes.get(key, 0) + 1
    return out


filter2d.launches = 0   # kernel launches since the last reset
filter2d.shapes = None  # set to a dict to tally calls by (B, H, W, C, kh, kw, per-sample)


def depthwise_conv2d(
    img: torch.Tensor, kernel: torch.Tensor, dilation: int = 1, pad_mode: str = "reflect"
) -> torch.Tensor:
    """Correlate every channel of an NHWC image with one (kh, kw) kernel,
    padded ('edge' or 'reflect') to a same-shape output; computed in f32."""
    c = img.shape[-1]
    kh, kw = kernel.shape
    ph, pw = ((kh - 1) * dilation + 1) // 2, ((kw - 1) * dilation + 1) // 2
    x = F.pad(img.permute(0, 3, 1, 2).float(), (pw, pw, ph, ph), mode=_PAD_MODES[pad_mode])
    k = kernel.to(device=img.device, dtype=torch.float32).expand(c, 1, kh, kw)
    out = F.conv2d(x, k, dilation=dilation, groups=c)
    return out.permute(0, 2, 3, 1).to(img.dtype)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable reflect-padded Gaussian blur on NHWC."""
    k1 = torch.from_numpy(gaussian_kernel1d(ksize, sigma))
    return depthwise_conv2d(depthwise_conv2d(img, k1[:, None]), k1[None, :])


def usm_sharpen(img: torch.Tensor, weight: float = 0.5, threshold: float = 10.0, radius: int = 51,
                sigma: float = 0.0) -> torch.Tensor:
    """Unsharp mask with a soft threshold mask; ``img`` is NHWC in [0, 1]."""
    blur = gaussian_blur(img, radius, sigma)
    residual = img - blur
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = gaussian_blur(mask, radius, sigma)
    sharp = (img + weight * residual).clamp(0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * img
