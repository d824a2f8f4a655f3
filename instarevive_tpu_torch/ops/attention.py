"""Attention: the plain PyTorch version and the hand-written CUDA flash kernel.

Layout: (B, H, N, D), with a (B, Nk) bool key mask (True = keep), as in
``instarevive_tpu/ops/attention.py``.

* ``sdpa``: plain matmul + softmax with f32 scores, masked scores set to
  -1e30 and an f32 softmax. It is the reference the kernel is held against
  and the CPU path.
* ``flash_attention``: wrapper of ``csrc/flash_attn_fwd.cu``, which replaces
  the TPU kernel ``_flash_kernel`` of ``instarevive_tpu/ops/attention.py``
  (through ``_flash_fwd_impl``). The kernel streams K/V tiles through shared
  memory with an online softmax, so the N x N scores never reach device
  memory; see the source for what bounds it on the H100 and how its design
  answers that. On a CPU tensor the wrapper runs ``sdpa``; on a CUDA tensor
  it launches the kernel or raises.
* ``attention``: the dispatch. Every unbiased attention on a CUDA tensor goes
  to the kernel, at every size; biased attention and all CPU work go to
  ``sdpa``. (SwinIR's biased window attention does not come here: it has its
  own kernel, ``ops/swin_attention.py``, whose plain version calls ``sdpa``.)

A fully masked row averages V over the real keys (as ``sdpa``), not over
the padded key length as the TPU kernel does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from instarevive_tpu_torch.ops.cuda_build import load_library

NEG_INF = -1e30
HEAD_DIMS = (72, 512)  # the kernel's instantiations: DiT heads and the VAE mid-block


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention. q: (B,H,Nq,D), k/v: (B,H,Nk,D); bias broadcastable to
    (B,H,Nq,Nk); kv_mask: (B,Nk) bool. Returns (B,H,Nq,D) in q.dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def _kernel():
    fn = load_library("flash_attn_fwd").flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention forward. q: (B,H,Nq,D), k/v: (B,H,Nk,D) in bf16 or
    f32 with D in ``HEAD_DIMS``; kv_mask: (B,Nk) bool. Inference only: raises
    if an input requires grad, since the kernel has no backward."""
    if not q.is_cuda:
        return sdpa(q, k, v, kv_mask=kv_mask, scale=scale)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or f32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS}, got {d}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward; call it under torch.no_grad()")
    if nq == 0 or nk == 0 or b * h > 65535:
        raise ValueError(f"unsupported sizes: B*H={b * h}, Nq={nq}, Nk={nk}")
    mask_ptr = None
    if kv_mask is not None:
        if kv_mask.shape != (b, nk) or kv_mask.dtype != torch.bool or kv_mask.device != q.device:
            raise ValueError(f"kv_mask must be a ({b}, {nk}) bool tensor on {q.device}")
        kv_mask = kv_mask.contiguous()
        mask_ptr = kv_mask.data_ptr()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    scale = d**-0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            b * h, h, nq, nk, d, scale, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the last reset


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dispatch: the CUDA kernel for every unbiased attention on the card,
    ``sdpa`` for biased attention and on the CPU."""
    if q.is_cuda and bias is None:
        return flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)
    return sdpa(q, k, v, bias=bias, kv_mask=kv_mask, scale=scale)
