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

Rounding points. bf16, both versions alike: the fold and ``silu(x * a + b)``
in f32; the activation rounded to bf16 (the convolution's input); weights in
bf16; products summed in f32; bias added in f32; one rounding to bf16 at the
end. f32: the fold, the activation and the bias in f32 as above; the kernel
runs each product as three exact tf32 products of split operands (hi =
tf32(v), lo = tf32(v - hi); lo.hi + hi.lo + hi.hi), within about 2^-21 of the
f32 product, and sums them in f32 (the tensor cores' sums over one chunk of
16 channels, then f32 adds); the plain version is an f32 convolution with
torch's TF32 off. The padding is zero after the SiLU.

The f32 kernel reads the weight's split planes in OHWI order
(``weight_planes``); a module packs them once (``nn.layers.Conv2d.tf32_planes``)
and hands them in as ``planes``, and a bare HWIO weight gets them made in the
wrapper, a prepass launch a call.

On a CPU tensor the wrapper runs ``gn_silu_conv3x3_plain``; on a CUDA tensor
it launches the kernels or raises. An input that requires grad gets the
kernels forward and, as the JAX package's ``custom_vjp``, the gradient of the
plain composition (``_GnSiluConv3x3``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from instarevive_tpu_torch.ops.cuda_build import load_library
from instarevive_tpu_torch.ops.norm_kernels import (
    f32_vector, raise_on_error, affine_silu_plain, check_nhwc, gn_affine, gn_affine_plain,
)
from instarevive_tpu_torch.ops.tf32_planes import tf32_planes


def gn_silu_conv3x3_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fold, multiply-add and SiLU in f32,
    the activation and the weights rounded to x's dtype, an f32 convolution
    with zero padding, bias in f32, one rounding of the output."""
    a, b = gn_affine_plain(x, gamma, beta, groups, eps)
    y = affine_silu_plain(x, a, b, silu=True).float()
    out = F.conv2d(y.permute(0, 3, 1, 2), w.to(x.dtype).float().permute(3, 2, 0, 1), bias.float(), padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def weight_planes(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-tf32 planes (hi, lo) of an HWIO weight (3, 3, C, Co) that the
    f32 kernel reads: each (Co, 3, 3, C) f32 in OHWI order (channels
    contiguous: a tf32 B operand of wgmma is read K-major only), bit for bit
    ``tf32_planes_plain`` of w permuted to (Co, 9, C). On a CUDA tensor the
    prepass kernel makes them (C at most 512; a launch of ``tf32_planes``,
    tallied there as (Co, 9, C, natural, not transposed)), on a CPU one its
    plain version."""
    kh, kw, c, co = w.shape
    hi, lo, _, _ = tf32_planes(w.detach().float().permute(3, 0, 1, 2).reshape(co, kh * kw, c).contiguous())
    return hi.view(co, kh, kw, c), lo.view(co, kh, kw, c)


@lru_cache(maxsize=None)
def _kernels():
    lib = load_library("gn_conv")
    lib.gn_silu_conv3x3.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.gn_silu_conv3x3_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.gn_silu_conv3x3.restype = lib.gn_silu_conv3x3_f32.restype = ctypes.c_int
    return lib


def _check_planes(planes, x: torch.Tensor, c: int, co: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if len(planes) != 2 or any(
            p.shape != (co, 3, 3, c) or p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous()
            or p.data_ptr() % 16 for p in planes):
        raise ValueError(f"gn_silu_conv3x3: planes must be two contiguous, 16-byte aligned ({co}, 3, 3, {c}) f32 "
                         f"tensors on {x.device} (weight_planes)")
    return planes


def gn_silu_conv3x3(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor, groups: int = 32, eps: float = 1e-6,
                    planes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """conv3x3_SAME(silu(GroupNorm(x; gamma, beta)), w) + bias. x: (N, H, W, C)
    in bf16 or f32; w: (3, 3, C, Co) HWIO; gamma, beta: (C,); bias: (Co,).
    On the card C and Co are multiples of 32 and w is contiguous, in x's dtype
    (pack it once per module, not per call); in f32 ``planes`` are w's
    ``weight_planes``, made here when not given. The CPU ignores ``planes``."""
    if not x.is_cuda:
        return gn_silu_conv3x3_plain(x, gamma, beta, w, bias, groups, eps)
    check_nhwc(x, "gn_silu_conv3x3", grad_ok=True)
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
    if x.dtype == torch.float32:
        planes = weight_planes(w) if planes is None else _check_planes(planes, x, c, co)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta, w, bias)):
        return _GnSiluConv3x3.apply(x, gamma, beta, w, bias, groups, eps, planes)
    return _forward(x, gamma, beta, w, bias, groups, eps, planes)


def _forward(x, gamma, beta, w, bias, groups, eps, planes):
    """The moments and fold kernels, then the convolution kernel, on checked
    inputs (outside autograd: the kernels see them detached)."""
    x, gamma, beta, w, bias = (t.detach() for t in (x, gamma, beta, w, bias))
    bias = f32_vector(bias, w.shape[3], x, "gn_silu_conv3x3 bias")
    a, b = gn_affine(x, gamma, beta, groups, eps)
    return _launch(x, a, b, w, bias, planes)


class _GnSiluConv3x3(torch.autograd.Function):
    """The kernels forward. The TPU kernel has no backward of its own (its
    ``custom_vjp`` differentiates the reference composition), so the backward
    is autograd through ``gn_silu_conv3x3_plain`` on the saved inputs, all
    five gradients."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, groups, eps, planes):
        ctx.save_for_backward(x, gamma, beta, w, bias)
        ctx.groups, ctx.eps = groups, eps
        return _forward(x, gamma, beta, w, bias, groups, eps, planes)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
            out = gn_silu_conv3x3_plain(*inputs, ctx.groups, ctx.eps)
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            planes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The convolution kernel alone on checked inputs, the fold (a, b) given;
    in f32 on w's planes (``weight_planes``)."""
    n, h, wd, c = x.shape
    co = w.shape[3]
    out = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.float32:
            err = _kernels().gn_silu_conv3x3_f32(
                x.data_ptr(), a.data_ptr(), b.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(),
                bias.data_ptr(), out.data_ptr(), n, h, wd, c, co, stream)
        else:
            err = _kernels().gn_silu_conv3x3(
                x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                n, h, wd, c, co, 1, stream)
    raise_on_error(err, "gn_silu_conv3x3")
    gn_silu_conv3x3.launches += 1
    if gn_silu_conv3x3.shapes is not None:
        key = (n, h, wd, c, co, "f32" if x.dtype == torch.float32 else "bf16")
        gn_silu_conv3x3.shapes[key] = gn_silu_conv3x3.shapes.get(key, 0) + 1
    return out


gn_silu_conv3x3.launches = 0  # kernel launches since the last reset
gn_silu_conv3x3.shapes = None  # set to a dict to tally launches by (N, H, W, C, Co, "bf16" or "f32")
