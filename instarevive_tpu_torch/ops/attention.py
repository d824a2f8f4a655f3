"""Attention: the plain PyTorch versions and the hand-written CUDA flash kernels.

Layout: (B, H, N, D), with a (B, Nk) bool key mask (True = keep), as in
``instarevive_tpu/ops/attention.py``.

* ``sdpa``: plain matmul + softmax with f32 scores, masked scores set to
  -1e30 and an f32 softmax. It is the reference the forward kernel is held
  against and the CPU path (with torch's own autograd).
* ``flash_attention``: wrapper of ``csrc/flash_attn_fwd.cu``, which replaces
  the TPU kernel ``_flash_kernel`` of ``instarevive_tpu/ops/attention.py``
  (through ``_flash_fwd_impl``). The kernel streams K/V tiles through shared
  memory with an online softmax, so the N x N scores never reach device
  memory; see the source for what bounds it on the H100 and how its design
  answers that. On a CPU tensor the wrapper runs ``sdpa``; on a CUDA tensor
  it launches the kernel or raises. When an input requires grad (head dim 64
  or 72, in f32 also 32 and 512) it goes through a ``torch.autograd.Function``: the
  forward kernel also writes the row log-sum-exp, and the backward is the two
  kernels of
  ``csrc/flash_attn_bwd.cu`` (``flash_dq``, ``flash_dkv``), which replace
  ``_flash_dq_kernel`` and ``_flash_dkv_kernel`` (through ``_flash_vjp_bwd``).
  ``di = rowsum(dO * O)`` is two plain elementwise torch ops in
  ``flash_backward``, as the JAX package leaves it to XLA outside its kernels.
* ``flash_lse_plain`` and ``flash_backward_plain`` repeat the kernels'
  arithmetic from the saved log-sum-exp in plain torch; the tests and the
  smoke run hold the kernels against them.
* f32, every head dim (32, 64, 72 and 512; bf16 takes 64, 72 and 512): the
  kernels run every product on the tensor cores as three tf32 products (hi.hi + hi.lo + lo.hi) of operands split into
  hi = tf32(x) and lo = tf32(x - hi), which keeps about 21 bits of each
  product. The prepass ``ops/tf32_planes.tf32_planes`` (with its own
  launch count) writes those planes before each launch, also transposed for a
  B operand whose K runs along the sequence (a tf32 operand of wgmma is read
  K-major only). At
  head dim 512 the forward reads Q raw and splits it in registers (its
  planes would not fit beside the rest), so it takes two prepass launches (K
  natural, V transposed) where head dims 32, 64 and 72 take three; its
  backward reads the row operands (Q and dO for dq, K and V for dk/dv) raw
  too, and the planes of the rest. The
  kernels' sums are f32 and torch's own TF32 stays off, so the f32 bounds are those of
  an f32 kernel.
* ``attention``: the dispatch. Every unbiased attention on a CUDA tensor goes
  to the kernels, at every size; biased attention and all CPU work go to
  ``sdpa``. (SwinIR's biased window attention does not come here: it has its
  own kernel, ``ops/swin_attention.py``, whose plain version calls ``sdpa``.)

A fully masked row averages V over the real keys (as ``sdpa``), not over
the padded key length as the TPU kernel does; its log-sum-exp is exactly
-1e30, and the backward takes that as the flag for "P = 1/Nk, dS = 0", the
gradient of that mean (what autograd gives through ``sdpa``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from instarevive_tpu_torch.ops.cuda_build import load_library
from instarevive_tpu_torch.ops.tf32_planes import tf32_planes

NEG_INF = -1e30
# The kernels' instantiations by dtype: the UNet/ControlNet heads (64), the DiT's (72), the VAE mid block (512,
# in bf16 forward only) and, in f32 only, the toy DiT of tools/train_validation.py (32, hidden 128 over 4 heads)
HEAD_DIMS = {torch.bfloat16: (64, 72, 512), torch.float32: (32, 64, 72, 512)}       # the forward kernel
GRAD_HEAD_DIMS = {torch.bfloat16: (64, 72), torch.float32: (32, 64, 72, 512)}        # the backward kernels
RAW_HEAD_DIM = 512      # the f32 kernels at this head dim read their row operands raw and split them in registers
DEAD_ROW = -1e29        # a log-sum-exp below this flags a row whose keys were all masked


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


def _bind(library: str, name: str, pointers: int):
    fn = getattr(load_library(library), name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _pointers(planes) -> ctypes.Array:
    return (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))


def _is_split(q: torch.Tensor) -> bool:
    """Whether these operands go to an f32 form on split-tf32 planes (every f32 one does)."""
    return q.dtype == torch.float32


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, kv_mask):
    """Raise on what the kernels do not take; returns (B, H, Nq, Nk, D)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or f32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS[q.dtype]} in {q.dtype}, got {d}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if nq == 0 or nk == 0 or b * h > 65535:
        raise ValueError(f"unsupported sizes: B*H={b * h}, Nq={nq}, Nk={nk}")
    if kv_mask is not None and (
            kv_mask.shape != (b, nk) or kv_mask.dtype != torch.bool or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be a ({b}, {nk}) bool tensor on {q.device}")
    return b, h, nq, nk, d


def _forward(q, k, v, kv_mask, scale, want_lse: bool):
    """Launch the forward kernel on checked, contiguous, aligned CUDA tensors.
    Returns (out, lse or None)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if want_lse else None
    mask_ptr, lse_ptr = None if kv_mask is None else kv_mask.data_ptr(), None if lse is None else lse.data_ptr()
    if _is_split(q):  # at head dim 512 Q goes raw: the kernel splits it in registers
        planes = [*([q] if d == RAW_HEAD_DIM else tf32_planes(q)[:2]), *tf32_planes(k)[:2],
                  *tf32_planes(v, natural=False, transposed=True)[2:]]
        fn = load_library("flash_attn_fwd").flash_attn_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(q.device):
            err = fn(_pointers(planes), mask_ptr, out.data_ptr(), lse_ptr, b * h, h, nq, nk, d, scale,
                     torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = _bind("flash_attn_fwd", "flash_attn_fwd", 6)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), lse_ptr,
                b * h, h, nq, nk, d, scale, 1, torch.cuda.current_stream().cuda_stream,  # bf16
            )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error {err}")
    flash_attention.launches += 1
    _tally(flash_attention, (b, h, nq, nk, d, kv_mask is not None, want_lse))
    return out, lse


def _tally(fn, key) -> None:
    if fn.shapes is not None:
        fn.shapes[key] = fn.shapes.get(key, 0) + 1


def _backward_args(q, k, v, kv_mask, lse, di, do):
    b, h, nq, d = q.shape
    if d not in GRAD_HEAD_DIMS[q.dtype]:
        raise ValueError(f"the flash-attention backward supports head dims {GRAD_HEAD_DIMS[q.dtype]} in {q.dtype}, "
                         f"got {d}")
    for name, t, shape in (("do", do, q.shape), ("lse", lse, (b, h, nq)), ("di", di, (b, h, nq))):
        if t.shape != shape or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} CUDA tensor, got {tuple(t.shape)}")
    if do.dtype != q.dtype or lse.dtype != torch.float32 or di.dtype != torch.float32:
        raise TypeError("do must have q's dtype; lse and di must be f32")
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), lse.data_ptr(), di.data_ptr()]


def backward_planes(q, k, v, do, kv: Optional[bool] = None):
    """The split planes the f32 backward kernels read, ``tf32_planes`` of q,
    k, v and dO: for the dq pass (kv False) K also transposed, for the dk/dv
    pass (kv True) Q and dO also transposed, for both (None) all three. (At
    head dim 512 a pass reads its row operands raw, beside the planes of the
    others.)"""
    return (tf32_planes(q, transposed=kv is not False), tf32_planes(k, transposed=kv is not True),
            tf32_planes(v), tf32_planes(do, transposed=kv is not False))


def _backward_f32(kv: bool, planes, raw, ptrs, outs, b, h, nq, nk, d, scale) -> int:
    """Launch one f32 backward pass on its planes (and at head dim 512 the
    raw ``(q, k, v, do)``); returns the CUDA error."""
    (qn, kn, vn, don) = planes
    split = [*qn[:2], *kn[:2], *vn[:2], *don[:2], *((*qn[2:], *don[2:]) if kv else kn[2:])]
    if d == RAW_HEAD_DIM:
        split += list(raw)
    fn = load_library("flash_attn_bwd").flash_attn_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(outs[0].device):
        return fn(_pointers(split), ptrs[4], ptrs[5], ptrs[6], outs[0].data_ptr(),
                  outs[1].data_ptr() if kv else None, int(kv), b * h, h, nq, nk, d, scale,
                  torch.cuda.current_stream().cuda_stream)


def flash_dq(q, k, v, kv_mask, lse, di, do, scale: float, planes=None) -> torch.Tensor:
    """dQ by the dq kernel. All tensors contiguous, 16-byte aligned, on the
    card; lse and di are (B, H, Nq) f32. In f32 the kernel reads the split
    planes of ``backward_planes``, made here unless ``planes`` holds them."""
    b, h, nq, nk, d = _check(q, k, v, kv_mask)
    ptrs = _backward_args(q, k, v, kv_mask, lse, di, do)
    dq = torch.empty_like(q)
    if _is_split(q):
        planes = backward_planes(q, k, v, do, kv=False) if planes is None else planes
        err = _backward_f32(False, planes, (q, k, v, do), ptrs, (dq,), b, h, nq, nk, d, scale)
    else:
        with torch.cuda.device(q.device):
            err = _bind("flash_attn_bwd", "flash_attn_bwd_dq", 8)(
                *ptrs, dq.data_ptr(), b * h, h, nq, nk, d, scale, 1, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dq launch failed with CUDA error {err}")
    flash_dq.launches += 1
    _tally(flash_dq, (b, h, nq, nk, d, kv_mask is not None))
    return dq


def flash_dkv(q, k, v, kv_mask, lse, di, do, scale: float, planes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) by the dk/dv kernel; arguments as ``flash_dq``."""
    b, h, nq, nk, d = _check(q, k, v, kv_mask)
    ptrs = _backward_args(q, k, v, kv_mask, lse, di, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _is_split(q):
        planes = backward_planes(q, k, v, do, kv=True) if planes is None else planes
        err = _backward_f32(True, planes, (q, k, v, do), ptrs, (dk, dv), b, h, nq, nk, d, scale)
    else:
        with torch.cuda.device(q.device):
            err = _bind("flash_attn_bwd", "flash_attn_bwd_dkv", 9)(
                *ptrs, dk.data_ptr(), dv.data_ptr(), b * h, h, nq, nk, d, scale, 1,
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv launch failed with CUDA error {err}")
    flash_dkv.launches += 1
    _tally(flash_dkv, (b, h, nq, nk, d, kv_mask is not None))
    return dk, dv


flash_dq.launches = 0   # kernel launches since the last reset
flash_dkv.launches = 0
flash_dq.shapes = flash_dkv.shapes = None  # set to a dict to tally launches by (B, H, Nq, Nk, D, masked)


def flash_backward(q, k, v, kv_mask, o, lse, do, scale: float):
    """(dQ, dK, dV) from the forward's output and log-sum-exp: the two
    kernels on the card, ``flash_backward_plain`` on the CPU."""
    if not q.is_cuda:
        return flash_backward_plain(q, k, v, kv_mask, o, lse, do, scale)
    do = _aligned(do)
    di = (do.float() * o.float()).sum(-1)
    planes = backward_planes(q, k, v, do) if _is_split(q) else None  # made once for both passes
    return (flash_dq(q, k, v, kv_mask, lse, di, do, scale, planes),
            *flash_dkv(q, k, v, kv_mask, lse, di, do, scale, planes))


def flash_lse_plain(q, k, kv_mask=None, scale: Optional[float] = None) -> torch.Tensor:
    """Row log-sum-exp of the masked, scaled scores as the forward kernel
    writes it: m + log(max(l, 1e-30)), (B, H, Nq) f32; -1e30 for a row with
    no real key."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    m = scores.amax(-1)
    l = torch.exp(scores - m[..., None]).sum(-1)
    return m + torch.log(l.clamp_min(1e-30))


def flash_backward_plain(q, k, v, kv_mask, o, lse, do, scale: float):
    """The backward kernels' arithmetic in plain torch, from the saved
    log-sum-exp (not autograd): P = exp(S scale - L) with masked keys at 0,
    dS = P (dP - di) scale, P and dS rounded to the operands' dtype before
    dV = P^T dO, dK = dS^T Q, dQ = dS K, sums in f32. A row flagged as fully
    masked (L < -1e29) takes P = 1/Nk on every key and dS = 0."""
    dt, nk = q.dtype, k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dead = (lse < DEAD_ROW)[..., None]
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    if kv_mask is not None:
        p = p.masked_fill(~kv_mask[:, None, None, :], 0.0)
    p = torch.where(dead, torch.full_like(p, 1.0 / nk), p)
    di = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - di) * scale
    ds = ds.masked_fill(dead, 0.0).to(dt).float()
    p = p.to(dt).float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dq = torch.matmul(ds, kf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp output; the backward is the
    dq and dk/dv kernels. q, k, v arrive contiguous and aligned."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        out, lse = _forward(q, k, v, kv_mask, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, kv_mask, out, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention. q: (B,H,Nq,D), k/v: (B,H,Nk,D) in bf16 or f32 with D
    in ``HEAD_DIMS`` of their dtype; kv_mask: (B,Nk) bool. Differentiable in
    q, k, v at the head dims of ``GRAD_HEAD_DIMS`` of their dtype (the
    backward kernels); elsewhere (bf16 at 512) an input that requires grad
    raises, naming its dtype."""
    if not q.is_cuda:
        return sdpa(q, k, v, kv_mask=kv_mask, scale=scale)
    d = _check(q, k, v, kv_mask)[-1]
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if needs_grad and d not in GRAD_HEAD_DIMS[q.dtype]:
        raise RuntimeError(f"flash_attention has no backward at head dim {d} in {q.dtype}; "
                           "call it under torch.no_grad()")
    if kv_mask is not None:
        kv_mask = kv_mask.contiguous()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    scale = d**-0.5 if scale is None else float(scale)
    if needs_grad:
        return _FlashAttention.apply(q, k, v, kv_mask, scale)
    return _forward(q, k, v, kv_mask, scale, want_lse=False)[0]


flash_attention.launches = 0  # forward-kernel launches since the last reset
flash_attention.shapes = None  # set to a dict to tally launches by (B, H, Nq, Nk, D, masked, with log-sum-exp)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dispatch: the CUDA kernels for every unbiased attention on the card,
    ``sdpa`` for biased attention and on the CPU."""
    if q.is_cuda and bias is None:
        return flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)
    return sdpa(q, k, v, bias=bias, kv_mask=kv_mask, scale=scale)
