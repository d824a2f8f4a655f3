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
so nothing of P is lost that an f32 sum would keep; the f32 kernel runs each
product as three tf32 products of split operands, hi = tf32(x), lo =
tf32(x - hi), lo.hi + hi.lo + hi.hi, within about 2^-21 of the f32 product);
one rounding to qkv's dtype at the end.

On a CPU tensor the wrapper runs ``swin_window_attention_plain``; on a CUDA
tensor it launches the kernel or raises. The TPU kernel has no backward (the
JAX package's SwinIR computes its attention inline under XLA's autodiff), so
none is written here: when qkv or the bias requires grad the kernel runs the
forward and the backward recomputes through the plain version under
``torch.enable_grad()`` (``_SwinWindowAttention``), the arrangement the JAX
package uses for its fused GN+SiLU+conv.
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
MAX_HEAD_DIM = 32  # head dims up to this
# The kernel's block (``geometry`` in the CUDA source): 8 warps; in shared
# memory a ring of up to MAX_SLOTS slots, each the per-head tiles of one work
# item (G heads); two blocks an SM (SM_SMEM bytes, of which each block
# reserves 1 KB more) wherever one slot fits them, else one block of up to
# SMEM_LIMIT; an item's part of a token row is at most ROW_UNITS 4-byte words.
SMEM_LIMIT, SM_SMEM, SMEM_HEADER, MAX_SLOTS, ROW_UNITS = 232448, 233472, 128, 4, 288


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


def ring_geometry(g: int, hd: int, element_size: int):
    """(slots of the ring, blocks an SM by shared memory) of the kernel's
    block for work items of ``g`` heads of ``hd``; 0 slots: the item does not
    fit."""
    slot = 3 * g * 64 * 40 * 2 if element_size == 2 else g * (2 * 64 * 36 + 32 * 68) * 4
    if 3 * g * hd * element_size // 4 > ROW_UNITS:
        return 0, 0
    two = (SM_SMEM // 2 - 1024 - SMEM_HEADER) // slot
    one = (SMEM_LIMIT - SMEM_HEADER) // slot
    return (min(MAX_SLOTS, two), 2) if two >= 1 else (min(MAX_SLOTS, one), 1)


@lru_cache(maxsize=None)
def heads_per_item(heads: int, hd: int, windows: int, sms: int, bf16: bool) -> int:
    """Heads a work item of the kernel takes (a divisor of ``heads``). A
    block's warps (8; 16 when the items are no more than the SMs, one block
    each) take an item's 4 x G (head, 16-row) tasks, and an SM holds two
    blocks of 8 warps. Of the sizes whose block fits and whose items the card
    takes in one wave (at most two an SM): the one with the least work on the
    busiest SM (its items times the task rounds an item takes), the larger on
    a tie; where no size gives one wave, the largest (fewest items, each with
    its copies' latency). At 6 heads of 30 on 132 SMs, bf16: 3 at 64 windows,
    6 at 80-104 and 256; f32 (whose block holds three heads at most): 3 at 64,
    96, 104 and 256 windows, 2 at 80: the fastest of 1, 2, 3 and 6 heads an
    item in ``tools/time_swin_attention.py`` at each of those shapes (NVIDIA
    H100 80GB HBM3, 700 W)."""
    es = 2 if bf16 else 4
    geo = {g: ring_geometry(g, hd, es) for g in range(1, heads + 1) if heads % g == 0}
    sizes = [g for g, (slots, _) in geo.items() if slots]

    def items(g):
        return windows * (heads // g)

    def rounds(g):  # items on the busiest SM
        return -(-items(g) // sms)

    def work(g):  # task rounds an item takes, counted in part where warps idle (the other block takes them)
        warps = 16 if items(g) <= sms else 8
        return rounds(g) * max(1.0, 4 * g / warps)

    one_wave = [g for g in sizes if rounds(g) <= geo[g][1]]
    return min(one_wave, key=lambda g: (work(g), -g)) if one_wave else max(sizes)


def _f32_table(t: torch.Tensor, shape: tuple, like: torch.Tensor, what: str, grad_ok: bool = False) -> None:
    if t.shape != shape or t.dtype != torch.float32 or t.device != like.device or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f"swin_window_attention: {what} must be a contiguous, 16-byte aligned {shape} f32 tensor on "
                         f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if t.requires_grad and not grad_ok:
        raise RuntimeError(f"swin_window_attention: {what} requires grad and takes no gradient here")


def _launch(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
            heads: int, window: int, scale: float, shift: int) -> torch.Tensor:
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    n_windows = (h // window) * (w // window)
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _kernel()(
            qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, h, w, heads, c // heads, window, shift, float(scale),
            heads_per_item(heads, c // heads, b * n_windows, _sm_count(qkv.device.index), qkv.dtype == torch.bfloat16),
            int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    raise_on_error(err, "swin_window_attention")
    swin_window_attention.launches += 1
    if swin_window_attention.shapes is not None:
        key = (b, h, w, c3, shift, mask is not None)
        swin_window_attention.shapes[key] = swin_window_attention.shapes.get(key, 0) + 1
    return out


class _SwinWindowAttention(torch.autograd.Function):
    """Kernel forward, plain recompute backward: the backward runs
    ``swin_window_attention_plain`` on the saved qkv and bias (in their own
    dtypes) under ``torch.enable_grad()`` and differentiates that."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, heads, window, scale, shift):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.args = (heads, window, scale, shift)
        return _launch(qkv, bias, mask, heads, window, scale, shift)

    @staticmethod
    def backward(ctx, grad):
        qkv, bias, mask = ctx.saved_tensors
        wanted = [i for i in (0, 1) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [qkv.detach().requires_grad_(0 in wanted), bias.detach().requires_grad_(1 in wanted)]
            out = swin_window_attention_plain(leaves[0], leaves[1], mask, *ctx.args)
            grads = dict(zip(wanted, torch.autograd.grad(out, [leaves[i] for i in wanted], grad)))
        return grads.get(0), grads.get(1), None, None, None, None, None


def swin_window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
                          heads: int, window: int, scale: float, shift: int = 0) -> torch.Tensor:
    """Windowed multi-head attention on a spatial map, the cyclic shift
    included. qkv: (B, H, W, 3C) in bf16 or f32; bias: (heads, N, N) f32;
    mask: (nWindows, N, N) additive f32 or None; returns (B, H, W, C) in
    qkv's dtype. On the card: ``window`` 8, head dim up to 32 (even in bf16),
    ``shift`` in [0, window); a qkv or bias that requires grad gets the kernel
    forward and the plain version's backward."""
    if qkv.dim() != 4 or qkv.shape[3] % (3 * heads):
        raise ValueError(f"swin_window_attention: qkv must be (B, H, W, 3 * heads * hd), got {tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    if h % window or w % window:
        raise ValueError(f"swin_window_attention: H and W must be multiples of window={window}, got {h} x {w}")
    if not 0 <= shift < window:
        raise ValueError(f"swin_window_attention: shift must be in [0, {window}), got {shift}")
    if not qkv.is_cuda:
        return swin_window_attention_plain(qkv, bias, mask, heads, window, scale, shift)
    check_nhwc(qkv, "swin_window_attention", grad_ok=True)
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
    _f32_table(bias, (heads, n, n), qkv, "bias", grad_ok=True)
    if mask is not None:
        _f32_table(mask, (n_windows, n, n), qkv, "mask")
    if qkv.requires_grad or bias.requires_grad:
        return _SwinWindowAttention.apply(qkv, bias, mask, heads, window, scale, shift)
    return _launch(qkv, bias, mask, heads, window, scale, shift)


swin_window_attention.launches = 0  # kernel launches since the last reset
swin_window_attention.shapes = None  # set to a dict to tally launches by (B, H, W, 3C, shift, masked)
