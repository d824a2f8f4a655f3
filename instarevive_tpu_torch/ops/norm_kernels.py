"""GroupNorm(+SiLU) and nearest 2x upsample on NHWC tensors: plain PyTorch
versions and the hand-written CUDA kernels
(``instarevive_tpu/ops/norm_kernels.py``).

The norm is two steps, as in the JAX package: per-(sample, channel) affine
``a = gamma * rstd``, ``b = beta - mean * a`` from f32 sums and sums of squares
(``gn_affine``), then ``y = x * a + b`` with an optional SiLU, in x's dtype
(``group_norm_silu``). ``gn_affine`` also feeds the fused GN+SiLU+conv kernel
(``ops/gn_conv.py``).

* ``gn_affine``: wrapper of ``stats_kernel`` + ``fold_kernel`` in
  ``csrc/norm_kernels.cu``, which replace the TPU kernel ``_stats_kernel`` and
  the fold that ``_gn_silu_pallas`` left to XLA.
* ``group_norm_silu``: ``gn_affine`` then ``apply_kernel``, which replaces the
  TPU kernel ``_apply_kernel``. An input that requires grad goes through
  ``_GroupNormSilu``: the kernels forward, autograd through
  ``group_norm_silu_plain`` backward, the input's gradient only (gamma and
  beta are read detached; one that requires grad raises).
* ``upsample2x_nearest``: wrapper of ``upsample_kernel``, which replaces the
  TPU kernel ``_upsample_kernel``.

Each has a ``*_plain`` version beside it that repeats the kernel's arithmetic
in PyTorch. On a CPU tensor a wrapper runs its plain version; on a CUDA
tensor it launches its kernel or raises. Each wrapper counts its launches.

The variance, E[x^2] - mean^2 in f32, is clamped at 0 before the rsqrt, as
``_gn_affine`` of ``instarevive_tpu/ops/gn_conv.py`` does; the unclamped fold
of ``_gn_silu_pallas`` can return NaN on a near-constant input.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from instarevive_tpu_torch.ops.cuda_build import load_library

MAX_CHANNELS = 1024  # the moments block gives each 16-byte vector along C one of its threads
STAT_THREADS = 256   # threads of a moments block
STAT_BLOCKS = 132 * 8  # moments blocks per launch: eight for each SM of the card


# ------------------------------------------------------------ plain versions


def gn_affine_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int = 32, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b), both (N, C) f32, with x * a + b == GroupNorm(x; gamma, beta).
    x: (N, H, W, C). Sums and sums of squares per channel in f32, then per
    group; variance clamped at 0."""
    n, h, w, c = x.shape
    cg = c // groups
    xf = x.float().reshape(n, h * w, c)
    count = h * w * cg
    mean = xf.sum(1).reshape(n, groups, cg).sum(-1) / count
    sq = (xf * xf).sum(1).reshape(n, groups, cg).sum(-1) / count
    rstd = torch.rsqrt((sq - mean * mean).clamp_min(0.0) + eps)
    a = gamma.float()[None] * rstd.repeat_interleave(cg, dim=1)
    b = beta.float()[None] - mean.repeat_interleave(cg, dim=1) * a
    return a, b


def affine_silu_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, silu: bool) -> torch.Tensor:
    """x * a + b per (sample, channel) in f32, optional SiLU, rounded to x.dtype."""
    y = x.float() * a[:, None, None, :] + b[:, None, None, :]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int = 32,
                          eps: float = 1e-6, silu: bool = True) -> torch.Tensor:
    return affine_silu_plain(x, *gn_affine_plain(x, gamma, beta, groups, eps), silu)


def upsample2x_nearest_plain(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


# ------------------------------------------------------------------ kernels


@lru_cache(maxsize=None)
def _kernels():
    lib = load_library("norm_kernels")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gn_stats_fold.argtypes = [ptr] * 6 + [i32] * 5 + [f32, i32, ptr]
    lib.gn_apply.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.upsample2x.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
    for fn in (lib.gn_stats_fold, lib.gn_apply, lib.upsample2x):
        fn.restype = ctypes.c_int
    return lib


def check_nhwc(x: torch.Tensor, what: str, arithmetic: bool = True, grad_ok: bool = False) -> None:
    """Raise unless the CUDA tensor x is what the kernels read: a 4-D tensor
    contiguous as NHWC, 16-byte aligned, in bf16 or f32 (any type of 2 or 4
    bytes when the kernel only moves it), and outside autograd unless the
    caller wraps the kernel in an ``autograd.Function`` (``grad_ok``)."""
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{what}: expected a non-empty (N, H, W, C) tensor, got shape {tuple(x.shape)}")
    if arithmetic and x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: bf16 or f32 only, got {x.dtype}")
    if x.element_size() not in (2, 4):
        raise TypeError(f"{what}: elements of 2 or 4 bytes only, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            f"{what}: the tensor must be contiguous as NHWC (strides {x.stride()} for shape {tuple(x.shape)}); "
            "permute a channels-last NCHW tensor to (0, 2, 3, 1) rather than copying"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the tensor's storage must be 16-byte aligned")
    if x.requires_grad and not grad_ok:
        raise RuntimeError(f"{what}: the kernel has no backward; call it under torch.no_grad()")
    if x.shape[1] * x.shape[2] >= 2**31:
        raise ValueError(f"{what}: shape {tuple(x.shape)} is beyond the kernels' 32-bit pixel index")


def f32_vector(t: torch.Tensor, c: int, like: torch.Tensor, what: str) -> torch.Tensor:
    if t.shape != (c,) or t.device != like.device:
        raise ValueError(f"{what}: expected a ({c},) tensor on {like.device}, got {tuple(t.shape)} on {t.device}")
    if t.requires_grad:
        raise RuntimeError(f"{what}: the kernel has no backward; call it under torch.no_grad()")
    return t.float().contiguous()  # no copy when the caller keeps it in f32


def _tally(fn, x: torch.Tensor) -> None:
    """One launch of ``fn`` on x (N, H, W, C) into ``fn.shapes`` when that is a dict."""
    if fn.shapes is not None:
        key = (*x.shape, "bf16" if x.dtype == torch.bfloat16 else "f32")
        fn.shapes[key] = fn.shapes.get(key, 0) + 1


def raise_on_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def gn_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              groups: int = 32, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GroupNorm fold (a, b), both (N, C) f32, of x (N, H, W, C) in bf16 or
    f32. On the card: C a multiple of 32 up to 1024, divisible by groups."""
    if not x.is_cuda:
        return gn_affine_plain(x, gamma, beta, groups, eps)
    check_nhwc(x, "gn_affine")
    n, h, w, c = x.shape
    if c % 32 or c > MAX_CHANNELS or groups < 1 or c % groups:
        raise ValueError(f"gn_affine: C must be a multiple of 32 up to {MAX_CHANNELS} and of groups={groups}, got {c}")
    gamma = f32_vector(gamma, c, x, "gn_affine gamma")
    beta = f32_vector(beta, c, x, "gn_affine beta")
    # pixels a block covers in one step; enough blocks to fill the card at batch 1
    rows = STAT_THREADS // (c * x.element_size() // 16)
    bps = max(1, min(-(-h * w // rows), STAT_BLOCKS // n))
    partial = torch.empty((n, bps, 2, c), dtype=torch.float32, device=x.device)
    a = torch.empty((n, c), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    with torch.cuda.device(x.device):
        err = _kernels().gn_stats_fold(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), partial.data_ptr(), a.data_ptr(), b.data_ptr(),
            n, h * w, c, groups, bps, float(eps), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on_error(err, "gn_stats_fold")
    gn_affine.launches += 1
    _tally(gn_affine, x)
    return a, b


def affine_silu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, silu: bool) -> torch.Tensor:
    """x * a + b per (sample, channel), optional SiLU, in x's dtype."""
    if not x.is_cuda:
        return affine_silu_plain(x, a, b, silu)
    check_nhwc(x, "group_norm_silu")
    n, h, w, c = x.shape
    if c % 32:
        raise ValueError(f"group_norm_silu: C must be a multiple of 32, got {c}")
    for t in (a, b):
        if t.shape != (n, c) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"group_norm_silu: a and b must be contiguous ({n}, {c}) f32 tensors on {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernels().gn_apply(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), n, h * w, c, int(silu),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    raise_on_error(err, "gn_apply")
    group_norm_silu.launches += 1
    _tally(group_norm_silu, x)
    return out


class _GroupNormSilu(torch.autograd.Function):
    """The moments, fold and apply kernels forward. The TPU kernels have no
    backward of their own (XLA differentiates the plain composition around
    them), so the backward is autograd through ``group_norm_silu_plain``,
    recomputed from the saved input, as ``ops/gn_conv._GnSiluConv3x3`` does:
    the input's gradient only (a frozen norm's gamma and beta, which the
    kernels read detached)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, silu):
        ctx.save_for_backward(x, gamma, beta)
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        x = x.detach()
        return affine_silu(x, *gn_affine(x, gamma, beta, groups, eps), silu)

    @staticmethod
    def backward(ctx, grad):
        x, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            out = group_norm_silu_plain(x, gamma, beta, ctx.groups, ctx.eps, ctx.silu)
            (gx,) = torch.autograd.grad(out, x, grad)
        return gx, None, None, None, None, None


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int = 32,
                    eps: float = 1e-6, silu: bool = True) -> torch.Tensor:
    """GroupNorm with f32 statistics and an optional SiLU; x: (N, H, W, C),
    output in x's dtype. ``group_norm_silu.launches`` counts the apply
    kernel; the moments kernels count under ``gn_affine.launches``. On the
    card an x that requires grad takes the kernels forward and the plain
    composition's input gradient backward (``_GroupNormSilu``)."""
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        check_nhwc(x, "group_norm_silu", grad_ok=True)
        return _GroupNormSilu.apply(x, gamma, beta, groups, eps, silu)
    return affine_silu(x, *gn_affine(x, gamma, beta, groups, eps), silu)


def _launch_upsample2x(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    out = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels().upsample2x(x.data_ptr(), out.data_ptr(), n, h, w, c * x.element_size(),
                                    torch.cuda.current_stream().cuda_stream)
    raise_on_error(err, "upsample2x")
    upsample2x_nearest.launches += 1
    _tally(upsample2x_nearest, x)
    return out


def upsample2x_backward(grad: torch.Tensor) -> torch.Tensor:
    """The gradient of the nearest 2x upsample: each input pixel collects its
    2x2 copies, summed in f32."""
    n, h2, w2, c = grad.shape
    return grad.reshape(n, h2 // 2, 2, w2 // 2, 2, c).sum(dim=(2, 4), dtype=torch.float32).to(grad.dtype)


class _Upsample2x(torch.autograd.Function):
    """The kernel forward; the TPU kernel has no backward of its own (XLA
    differentiates the plain broadcast there), so the backward is the plain
    2x2 sum."""

    @staticmethod
    def forward(ctx, x):
        return _launch_upsample2x(x)

    @staticmethod
    def backward(ctx, grad):
        return upsample2x_backward(grad)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample: (N, H, W, C) -> (N, 2H, 2W, C). On the card a
    channel row must be a multiple of 16 bytes; an input that requires grad
    gets the kernel forward and the plain 2x2-sum backward."""
    if not x.is_cuda:
        return upsample2x_nearest_plain(x)
    check_nhwc(x, "upsample2x_nearest", arithmetic=False, grad_ok=True)
    row_bytes = x.shape[3] * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"upsample2x_nearest: C * element size must be a multiple of 16 bytes, got {row_bytes}")
    return _Upsample2x.apply(x) if x.requires_grad else _launch_upsample2x(x)


# kernel launches since the last reset
gn_affine.launches = 0
group_norm_silu.launches = 0
upsample2x_nearest.launches = 0
# set to a dict to tally launches by (N, H, W, C, "bf16" or "f32") of the input
gn_affine.shapes = group_norm_silu.shapes = upsample2x_nearest.shapes = None
