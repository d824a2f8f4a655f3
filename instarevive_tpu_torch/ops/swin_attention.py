"""Swin window attention on a fused NHWC qkv map: the plain PyTorch version
and the hand-written CUDA kernel (``instarevive_tpu/ops/swin_attention.py``).

``swin_window_attention(qkv, bias, mask, heads, window, scale, shift)`` takes
the fused projection ``(B, H, W, 3C)`` in NHWC with lane order
``[q_h0..q_h{heads-1}, k_.., v_..]`` (a ``Linear(3C)`` output read as
``(3, heads, hd)``), H and W multiples of ``window``. For every
``window x window`` window of the map rolled by ``-shift`` and every head it
computes ``softmax(q k^T * scale + bias[h] + mask[window]) v`` with f32 scores,
softmax and P.V, and returns ``(B, H, W, C)`` in qkv's dtype with every token
back at its own place. ``bias`` is ``(heads, N, N)`` f32, ``mask`` is
``(nWindows, N, N)`` additive f32 or None, ``N = window * window``.

It wraps ``csrc/swin_attention.cu``, which replaces the TPU kernel ``_kernel``
of ``instarevive_tpu/ops/swin_attention.py`` (through its
``swin_window_attention``). That kernel leaves the cyclic roll outside; here
it is folded in: a CUDA block computes its own addresses, so it reads token
``(y, x)`` of the rolled map from ``((y + shift) % H, (x + shift) % W)`` and
writes its output there. The function with ``shift=0`` is the TPU kernel's;
with a shift it is ``roll -> that function -> roll back``.

Rounding points, both versions alike: q, k, v as stored; scores, softmax and
P.V in f32 (the bf16 kernel carries P as two bf16 terms, 16 bits of mantissa,
so nothing of P is lost that an f32 sum would keep); one rounding to qkv's
dtype at the end.

On a CPU tensor the wrapper runs ``swin_window_attention_plain``; on a CUDA
tensor it launches the kernel or raises. Forward only.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from instarevive_tpu_torch.ops import window as W
from instarevive_tpu_torch.ops.attention import sdpa
from instarevive_tpu_torch.ops.cuda_build import load_library
from instarevive_tpu_torch.ops.norm_kernels import check_nhwc, raise_on_error

WINDOW = 8         # the kernel's window: 64 tokens, four 16-row MMA tiles
MAX_HEAD_DIM = 32  # head dims up to this, zero-padded to it in shared memory only
# Most heads a block of the bf16 kernel takes together (15 KB of shared memory
# each); the grid is windows x (heads / heads per block).
MAX_HEADS_PER_BLOCK = 6


def swin_window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                                heads: int, window: int, scale: float, shift: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: roll, partition into windows, split
    the heads, ``sdpa`` with the bias and mask added to f32 scores, reverse,
    roll back."""
    b, h, w, c3 = qkv.shape
    c, n = c3 // 3, window * window
    if shift:
        qkv = W.cyclic_shift(qkv, shift)
    xw = W.window_partition(qkv, window)  # (B * nW, N, 3C)
    q, k, v = xw.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    add = bias.float()[None]  # (1, heads, N, N)
    if mask is not None:
        add = (add + mask.float()[:, None]).repeat(b, 1, 1, 1)  # (B * nW, heads, N, N)
    out = sdpa(q, k, v, bias=add, scale=scale)
    out = W.window_reverse(out.transpose(1, 2).reshape(-1, n, c), window, h, w)
    return W.cyclic_unshift(out, shift) if shift else out


@lru_cache(maxsize=None)
def _kernel():
    fn = load_library("swin_attention").swin_window_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def heads_per_block(heads: int, windows: int, sms: int) -> int:
    """Heads a block of the bf16 kernel takes: the largest divisor of
    ``heads`` up to ``MAX_HEADS_PER_BLOCK`` that still leaves a block for
    every SM, else 1. More heads a block make a token's row one long coalesced
    read (at 256 windows 0.024 ms with 6 against 0.045 ms with 1); too few
    blocks leave SMs idle (at 64 windows 0.017 ms with 6, 0.012-0.013 ms with
    3 or 2). Figures: ``tools/time_swin_attention.py`` on an NVIDIA H100 80GB
    HBM3 at 700 W, 6 heads of 30."""
    fits = [d for d in range(1, MAX_HEADS_PER_BLOCK + 1) if heads % d == 0 and windows * (heads // d) >= sms]
    return max(fits, default=1)


def _f32_table(t: torch.Tensor, shape: tuple, like: torch.Tensor, what: str) -> None:
    if t.shape != shape or t.dtype != torch.float32 or t.device != like.device or not t.is_contiguous():
        raise ValueError(f"swin_window_attention: {what} must be a contiguous {shape} f32 tensor on {like.device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if t.requires_grad:
        raise RuntimeError(f"swin_window_attention: {what} requires grad and the kernel has no backward; "
                           "call it under torch.no_grad()")


def swin_window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                          heads: int, window: int, scale: float, shift: int = 0) -> torch.Tensor:
    """Windowed multi-head attention on a spatial map, the cyclic shift
    included. qkv: (B, H, W, 3C) in bf16 or f32; bias: (heads, N, N) f32;
    mask: (nWindows, N, N) additive f32 or None; returns (B, H, W, C) in
    qkv's dtype. On the card: ``window`` 8, head dim up to 32 (even in bf16),
    ``shift`` in [0, window)."""
    if qkv.dim() != 4 or qkv.shape[3] % (3 * heads):
        raise ValueError(f"swin_window_attention: qkv must be (B, H, W, 3 * heads * hd), got {tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    if h % window or w % window:
        raise ValueError(f"swin_window_attention: H and W must be multiples of window={window}, got {h} x {w}")
    if not 0 <= shift < window:
        raise ValueError(f"swin_window_attention: shift must be in [0, {window}), got {shift}")
    if not qkv.is_cuda:
        return swin_window_attention_plain(qkv, bias, mask, heads, window, scale, shift)
    check_nhwc(qkv, "swin_window_attention")
    c = c3 // 3
    hd, n = c // heads, window * window
    if window != WINDOW:
        raise ValueError(f"swin_window_attention: the kernel takes window {WINDOW} only, got {window}")
    bf16 = qkv.dtype == torch.bfloat16
    if hd > MAX_HEAD_DIM or (bf16 and hd % 2):
        raise ValueError(f"swin_window_attention: the kernel takes head dims up to {MAX_HEAD_DIM}, "
                         f"even ones in bf16; got {hd}")
    if b * h * w >= 2**31 // c3:
        raise ValueError(f"swin_window_attention: shape {tuple(qkv.shape)} is beyond the kernel's 32-bit index")
    n_windows = (h // window) * (w // window)
    _f32_table(bias, (heads, n, n), qkv, "bias")
    if mask is not None:
        _f32_table(mask, (n_windows, n, n), qkv, "mask")
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _kernel()(
            qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, h, w, heads, hd, window, shift, float(scale),
            heads_per_block(heads, b * n_windows, _sm_count(qkv.device.index)), int(bf16),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on_error(err, "swin_window_attention")
    swin_window_attention.launches += 1
    if swin_window_attention.shapes is not None:
        key = (b, h, w, c3, shift, mask is not None)
        swin_window_attention.shapes[key] = swin_window_attention.shapes.get(key, 0) + 1
    return out


swin_window_attention.launches = 0  # kernel launches since the last reset
swin_window_attention.shapes = None  # set to a dict to tally launches by (B, H, W, 3C, shift, masked)
