"""Optimizers and LR schedules (``instarevive_tpu/train/optim.py``), written
against lists of tensors so that they compute optax's updates exactly:

* AdamW as ``optax.adamw``: ``m_hat / (sqrt(v_hat) + eps)``, decoupled weight
  decay added to the update, the schedule read at the count before its
  increment;
* AdamW with both moments stored in a low-memory dtype (``adamw_lowmem``:
  bf16 moments, f32 arithmetic);
* Lion as ``optax.lion``; CAME as the JAX package implements it (factored
  second moment over the last two dims, confidence-weighted momentum, its
  schedule read at the count after the increment);
* ``clip_by_global_norm`` (no ``+1e-6`` in the divisor) ahead of each, and
  gradient accumulation as ``optax.MultiSteps``: a running mean of the
  gradients, the inner update on every k-th call, no update in between.

An ``Optimizer`` is stateless; ``init(params)`` makes its state (a dict of
ints and lists of tensors, which ``train/checkpoint.py`` saves as it is) and
``update(params, grads, state)`` changes params and state in place. Nothing
here reads a value back from the device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]


def auto_scale_lr(base_lr: float, effective_bs: int, base_bs: int = 256, rule: str = "sqrt") -> float:
    """lr scaling rule."""
    ratio = effective_bs / base_bs
    return base_lr * (math.sqrt(ratio) if rule == "sqrt" else ratio)


# ---------------------------------------------------------------------------
# LR schedules


def constant_with_warmup(lr: float, warmup_steps: int) -> Schedule:
    def sched(step: int) -> float:
        return lr * min(1.0, (step + 1) / max(warmup_steps, 1))

    return sched


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    def sched(step: int) -> float:
        warm = min(1.0, (step + 1) / max(warmup_steps, 1))
        prog = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return lr * warm * 0.5 * (1.0 + math.cos(math.pi * prog))

    return sched


def cosine_decay_to_constant_with_warmup(
    lr: float, warmup_steps: int, total_steps: int, final_ratio: float = 0.05, decay_fraction: float = 1.0,
) -> Schedule:
    """Cosine decays over decay_fraction of the run, then holds final_ratio."""
    decay_steps = max(int((total_steps - warmup_steps) * decay_fraction), 1)

    def sched(step: int) -> float:
        warm = min(1.0, (step + 1) / max(warmup_steps, 1))
        prog = min(max((step - warmup_steps) / decay_steps, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * prog))
        factor = final_ratio if prog >= 1.0 else cos * (1 - final_ratio) + final_ratio
        return lr * warm * factor

    return sched


def _lr(learning_rate: Union[float, Schedule], count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


# ---------------------------------------------------------------------------
# Optimizers


class Optimizer:
    """Base: ``init(params) -> state``; ``update(params, grads, state)`` in place."""

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        raise NotImplementedError

    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: Dict) -> None:
        raise NotImplementedError


class AdamW(Optimizer):
    """``optax.adamw``; with ``moment_dtype`` the low-memory form, whose
    moments are upcast, updated in f32 and stored back."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, moment_dtype=None):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.moment_dtype = weight_decay, moment_dtype

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)  # noqa: E731
        return {"count": 0, "mu": [zeros(p) for p in params], "nu": [zeros(p) for p in params]}

    def update(self, params, grads, state):
        b1, b2 = self.b1, self.b2
        lr = _lr(self.learning_rate, state["count"])
        state["count"] += 1
        bc1, bc2 = 1.0 - b1 ** state["count"], 1.0 - b2 ** state["count"]
        stored_mu, stored_nu = state["mu"], state["nu"]
        low = self.moment_dtype is not None
        mu = [m.float() for m in stored_mu] if low else stored_mu
        nu = [v.float() for v in stored_nu] if low else stored_nu
        grads = [g.float() for g in grads] if low else grads
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, bc1)
        torch._foreach_div_(step, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(step, [p.float() for p in params] if low else list(params), alpha=self.weight_decay)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(list(params), [s.to(p.dtype) for s, p in zip(step, params)] if low else step)
        if low:
            for dst, src in zip(stored_mu + stored_nu, mu + nu):
                dst.copy_(src)


class Lion(Optimizer):
    """``optax.lion``: the sign of an interpolated momentum; the momentum may
    be stored in ``mu_dtype``."""

    def __init__(self, learning_rate, b1=0.9, b2=0.99, weight_decay=0.0, mu_dtype=None):
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.weight_decay, self.mu_dtype = weight_decay, mu_dtype

    def init(self, params):
        return {"count": 0, "mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params]}

    def update(self, params, grads, state):
        lr = _lr(self.learning_rate, state["count"])
        state["count"] += 1
        for p, g, m in zip(params, grads, state["mu"]):
            m32 = m.to(g.dtype)
            step = torch.sign((1.0 - self.b1) * g + self.b1 * m32)
            if self.weight_decay:
                step = step + self.weight_decay * p
            m.copy_(self.b2 * m32 + (1.0 - self.b2) * g)
            p.add_(step.to(p.dtype), alpha=-lr)


class CAME(Optimizer):
    """CAME (Luo et al. 2023), factored over the last two dims; parameters
    with fewer than two dims keep a full second moment."""

    def __init__(self, learning_rate, betas=(0.9, 0.999, 0.9999), eps=(1e-30, 1e-16), weight_decay=0.0,
                 clip_threshold=1.0):
        self.learning_rate, self.betas, self.eps = learning_rate, betas, eps
        self.weight_decay, self.clip_threshold = weight_decay, clip_threshold

    def init(self, params):
        def rows(p):
            return torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device) if p.ndim >= 2 else torch.zeros_like(p)

        def cols(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else ()
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        return {"count": 0, "m": [torch.zeros_like(p) for p in params],
                "vr": [rows(p) for p in params], "vc": [cols(p) for p in params],
                "rr": [rows(p) for p in params], "rc": [cols(p) for p in params]}

    def _approx(self, r, c):
        # RMS-factored approximation: (r_i * c_j) / mean(r)
        denom = r.mean(dim=-1, keepdim=True).clamp_min(self.eps[0])
        return r[..., None] * c[..., None, :] / denom[..., None]

    def update(self, params, grads, state):
        b1, b2, b3 = self.betas
        eps1, eps2 = self.eps
        state["count"] += 1
        lr = _lr(self.learning_rate, state["count"])
        for i, (p, g) in enumerate(zip(params, grads)):
            m, vr, vc, rr, rc = (state[k][i] for k in ("m", "vr", "vc", "rr", "rc"))
            factored = g.ndim >= 2
            if factored:
                g2 = g * g + eps1
                vr.mul_(b2).add_(g2.mean(dim=-1), alpha=1 - b2)
                vc.mul_(b2).add_(g2.mean(dim=-2), alpha=1 - b2)
                u = g * torch.rsqrt(self._approx(vr, vc))
            else:
                vr.mul_(b2).add_(g * g + eps1, alpha=1 - b2)
                u = g * torch.rsqrt(vr)
            rms = torch.sqrt(torch.mean(u * u) + eps1)  # update clipping by RMS
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            m.mul_(b1).add_(u, alpha=1 - b1)
            if factored:
                res = (u - m) ** 2 + eps2
                rr.mul_(b3).add_(res.mean(dim=-1), alpha=1 - b3)
                rc.mul_(b3).add_(res.mean(dim=-2), alpha=1 - b3)
                out = m * torch.rsqrt(self._approx(rr, rc))
            else:
                out = m
            if self.weight_decay:
                out = out + self.weight_decay * p
            p.add_(out, alpha=-lr)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: gradients scaled by max_norm / norm when
    the norm is at least max_norm. The factor stays on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(list(grads), factor)


class Chain(Optimizer):
    """Global-norm clipping, then the optimizer, under ``optax.MultiSteps``
    when ``grad_accum > 1``."""

    def __init__(self, opt: Optimizer, grad_clip_norm: Optional[float], grad_accum: int):
        self.opt, self.grad_clip_norm, self.grad_accum = opt, grad_clip_norm, grad_accum

    def init(self, params):
        state = {"inner": self.opt.init(params)}
        if self.grad_accum > 1:
            state.update(mini_step=0, gradient_step=0, acc_grads=[torch.zeros_like(p) for p in params])
        return state

    def _inner(self, params, grads, state):
        if self.grad_clip_norm:
            grads = clip_by_global_norm(grads, self.grad_clip_norm)
        self.opt.update(params, grads, state["inner"])

    @torch.no_grad()
    def update(self, params, grads, state):
        if self.grad_accum <= 1:
            return self._inner(params, grads, state)
        acc, n = state["acc_grads"], state["mini_step"]
        for a, g in zip(acc, grads):  # running mean of the gradients seen since the last update
            a.add_((g - a) / (n + 1))
        if n == self.grad_accum - 1:
            self._inner(params, acc, state)
            state["gradient_step"] += 1
            torch._foreach_zero_(acc)
        state["mini_step"] = (n + 1) % self.grad_accum


def build_optimizer(
    name: str = "adamw",
    learning_rate: Union[float, Schedule] = 1e-5,
    weight_decay: float = 0.0,
    betas=(0.9, 0.999),
    grad_clip_norm: Optional[float] = 10.0,
    grad_accum: int = 1,
    moment_dtype: Optional[torch.dtype] = None,  # e.g. torch.bfloat16: low-memory moments
) -> Optimizer:
    if name == "adamw":
        opt = AdamW(learning_rate, b1=betas[0], b2=betas[1], weight_decay=weight_decay, moment_dtype=moment_dtype)
    elif name == "lion":
        opt = Lion(learning_rate, b1=betas[0], b2=betas[1], weight_decay=weight_decay, mu_dtype=moment_dtype)
    elif name == "came":
        opt = CAME(learning_rate, weight_decay=weight_decay)
    else:
        raise ValueError(name)
    return Chain(opt, grad_clip_norm, grad_accum)
