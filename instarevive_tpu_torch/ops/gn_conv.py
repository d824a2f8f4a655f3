"""Fused GroupNorm + SiLU + 3x3 SAME convolution on NHWC tensors: the plain
PyTorch version and the hand-written CUDA kernel
(``instarevive_tpu/ops/gn_conv.py``).

``gn_silu_conv3x3(x, gamma, beta, w, bias)`` is
``conv3x3_SAME(silu(GroupNorm(x)), w) + bias`` with x (N, H, W, C), w
(3, 3, C, Co) HWIO, as every half of a VAE ResnetBlock computes it. It wraps
``csrc/gn_conv.cu``, which replaces the TPU kernel ``_kernel`` of
``instarevive_tpu/ops/gn_conv.py`` (through ``_fused_call``): the GroupNorm
fold comes from the moments kernels (``ops/norm_kernels.gn_affine``), and the
normalised, activated tensor is made in the convolution's load and never
reaches device memory.

Rounding points, both versions alike: the fold and ``silu(x * a + b)`` in
f32; the activation rounded to x's dtype (the convolution's input); weights in
x's dtype; products summed in f32; bias added in f32; one rounding to x's
dtype at the end. The padding is zero after the SiLU.

On a CPU tensor the wrapper runs ``gn_silu_conv3x3_plain``; on a CUDA tensor
it launches the kernels or raises. Forward only: an input that requires grad
is refused.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from instarevive_tpu_torch.ops.cuda_build import load_library
from instarevive_tpu_torch.ops.norm_kernels import (
    f32_vector, raise_on_error, affine_silu_plain, check_nhwc, gn_affine, gn_affine_plain,
)


def gn_silu_conv3x3_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fold, multiply-add and SiLU in f32,
    the activation and the weights rounded to x's dtype, an f32 convolution
    with zero padding, bias in f32, one rounding of the output."""
    a, b = gn_affine_plain(x, gamma, beta, groups, eps)
    y = affine_silu_plain(x, a, b, silu=True).float()
    out = F.conv2d(y.permute(0, 3, 1, 2), w.to(x.dtype).float().permute(3, 2, 0, 1), bias.float(), padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


@lru_cache(maxsize=None)
def _kernel():
    fn = load_library("gn_conv").gn_silu_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gn_silu_conv3x3(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """conv3x3_SAME(silu(GroupNorm(x; gamma, beta)), w) + bias. x: (N, H, W, C)
    in bf16 or f32; w: (3, 3, C, Co) HWIO; gamma, beta: (C,); bias: (Co,).
    On the card C and Co are multiples of 32 and w is contiguous, in x's dtype
    (pack it once per module, not per call)."""
    if not x.is_cuda:
        return gn_silu_conv3x3_plain(x, gamma, beta, w, bias, groups, eps)
    check_nhwc(x, "gn_silu_conv3x3")
    n, h, wd, c = x.shape
    if w.dim() != 4 or w.shape[:3] != (3, 3, c):
        raise ValueError(f"gn_silu_conv3x3: w must be (3, 3, {c}, Co) HWIO, got {tuple(w.shape)}")
    co = w.shape[3]
    if c % 32 or co % 32:
        raise ValueError(f"gn_silu_conv3x3: C and Co must be multiples of 32, got {c} and {co}")
    if w.dtype != x.dtype or w.device != x.device or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(
            f"gn_silu_conv3x3: w must be a contiguous, 16-byte aligned {x.dtype} tensor on {x.device}, "
            f"got {w.dtype} on {w.device} with strides {w.stride()}"
        )
    if w.requires_grad:
        raise RuntimeError("gn_silu_conv3x3: the kernel has no backward; call it under torch.no_grad()")
    bias = f32_vector(bias, co, x, "gn_silu_conv3x3 bias")
    a, b = gn_affine(x, gamma, beta, groups, eps)
    return _launch(x, a, b, w, bias)


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The convolution kernel alone on checked inputs, the fold (a, b) given."""
    n, h, wd, c = x.shape
    co = w.shape[3]
    out = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, wd, c, co, int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    raise_on_error(err, "gn_silu_conv3x3")
    gn_silu_conv3x3.launches += 1
    if gn_silu_conv3x3.shapes is not None:
        key = (n, h, wd, c, co)
        gn_silu_conv3x3.shapes[key] = gn_silu_conv3x3.shapes.get(key, 0) + 1
    return out


gn_silu_conv3x3.launches = 0  # kernel launches since the last reset
gn_silu_conv3x3.shapes = None  # set to a dict to tally launches by (N, H, W, C, Co)
