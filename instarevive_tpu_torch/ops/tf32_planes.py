"""The split prepass of the f32 kernels (``csrc/tf32_planes.cu``) and its
plain version.

Every f32 kernel of the port runs its products on the tensor cores as three
tf32 products of operands split into hi = tf32(v) and lo = tf32(v - hi)
(lo.hi + hi.lo + hi.hi, about 21 bits of each f32 product). A tf32 operand
of wgmma is read from shared memory K-major only, so the prepass writes the
planes in the operand's own layout and, for an operand whose K runs along
the sequence, transposed. Its readers: the flash-attention forward and
backward in f32 (``ops/attention.py``: q, k, v and dO before each launch)
and the f32 form of the fused conv (``ops/gn_conv.weight_planes``: a conv
weight in OHWI order, (Co, 9, C), once per module).

``tf32_planes`` launches the prepass on a CUDA tensor and runs
``tf32_planes_plain``, its bit-exact plain version, on a CPU one.
"""

from __future__ import annotations

import ctypes

import torch

from instarevive_tpu_torch.ops.cuda_build import load_library

# The transposed planes' order along the sequence within each group of 8: position j holds entry
# PERM8[j], the order in which a thread's accumulator columns (2t, 2t+1) become tf32 A-fragment k (t, t+4).
PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)


def pad8(n: int) -> int:
    """The transposed planes' row length: n rounded up to a multiple of 8."""
    return (n + 7) // 8 * 8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: f32 values whose low 13 bits are
    zero."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000  # the magnitude's bits: adding half a tf32 step rounds ties away from 0
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def tf32_planes_plain(x: torch.Tensor, natural: bool = True, transposed: bool = False):
    """The split of an f32 operand ``x`` (..., n, d) into hi = tf32(x) and
    lo = tf32(x - hi), bit for bit as ``csrc/tf32_planes.cu``: (hi, lo, t_hi,
    t_lo), the planes in x's layout (or None unless ``natural``) and
    transposed to (..., d, pad8(n)) with zeros past n and the sequence in the
    order ``PERM8`` within each group of 8 (or None unless ``transposed``)."""
    x = x.float().contiguous()
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    if not transposed:
        return (hi, lo, None, None) if natural else (None, None, None, None)
    n, n_pad = x.shape[-2], pad8(x.shape[-2])

    def transpose(p):
        p = torch.nn.functional.pad(p.transpose(-1, -2), (0, n_pad - n))
        return p.reshape(*p.shape[:-1], n_pad // 8, 8)[..., list(PERM8)].reshape(p.shape).contiguous()

    return (hi if natural else None, lo if natural else None, transpose(hi), transpose(lo))


def tf32_planes(x: torch.Tensor, natural: bool = True, transposed: bool = False):
    """``tf32_planes_plain`` by the prepass kernel on a CUDA tensor (f32,
    contiguous, head dim at most 512); the plain version on a CPU one."""
    if not x.is_cuda:
        return tf32_planes_plain(x, natural, transposed)
    if x.dtype != torch.float32 or x.dim() < 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"tf32_planes takes a contiguous, 16-byte aligned f32 tensor, got {x.dtype} {tuple(x.shape)}")
    *lead, n, d = x.shape
    bh = x.numel() // max(n * d, 1)
    if not (1 <= d <= 512 and n >= 1 and 1 <= bh <= 65535):
        raise ValueError(f"tf32_planes: unsupported shape {tuple(x.shape)}")
    hi = lo = t_hi = t_lo = None
    if natural:
        hi, lo = torch.empty_like(x), torch.empty_like(x)
    if transposed:
        t_hi = x.new_empty((*lead, d, pad8(n)))
        t_lo = torch.empty_like(t_hi)
    fn = load_library("tf32_planes").tf32_planes
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), *(None if p is None else p.data_ptr() for p in (hi, lo, t_hi, t_lo)), bh, n, d,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tf32_planes launch failed with CUDA error {err}")
    tf32_planes.launches += 1
    if tf32_planes.shapes is not None:
        key = (bh, n, d, natural, transposed)
        tf32_planes.shapes[key] = tf32_planes.shapes.get(key, 0) + 1
    return hi, lo, t_hi, t_lo


tf32_planes.launches = 0  # prepass launches since the last reset
tf32_planes.shapes = None  # set to a dict to tally launches by (bh, n, d, natural, transposed)
