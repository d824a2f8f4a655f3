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
here reads a value back from the device. ``update(..., ok=flag)`` (a 0-dim
bool tensor on the device; the gradients finite) gates the whole update on
the device, as ``utils.debug.nan_guard`` needs: where the flag is down every
tensor of params and state keeps its bits and the count does not advance.
The count is then a 0-dim tensor, and the schedules and bias corrections are
computed from it on the device (the schedules take an int or a tensor).

Under FSDP2 each rank updates its dim-0 shards of the parameters, and
``update(..., shards=)`` (``train/state.Shards``: the shard group and each
parameter's full dim 0) names what crosses shards: the global gradient norm
sums its squares over the group, and CAME's means over dim 0 (its column
statistics of a 2-D weight, the mean of its row statistics, the RMS of its
update) are sums over the group divided by the full size. ``layout()`` says
how each per-parameter list of the state is laid out, for the one-card
checkpoint (``train/state.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

Schedule = Callable[[int], float]
Count = Union[int, torch.Tensor]


def _min1(x):
    """min(x, 1) of a number or a tensor, without reading the tensor."""
    return torch.clamp(x, max=1.0) if isinstance(x, torch.Tensor) else min(x, 1.0)


def _clip01(x):
    return torch.clamp(x, 0.0, 1.0) if isinstance(x, torch.Tensor) else min(max(x, 0.0), 1.0)


def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else math.cos(x)


def auto_scale_lr(base_lr: float, effective_bs: int, base_bs: int = 256, rule: str = "sqrt") -> float:
    """lr scaling rule."""
    ratio = effective_bs / base_bs
    return base_lr * (math.sqrt(ratio) if rule == "sqrt" else ratio)


# ---------------------------------------------------------------------------
# LR schedules


def constant_with_warmup(lr: float, warmup_steps: int) -> Schedule:
    def sched(step: Count):
        return lr * _min1((step + 1) / max(warmup_steps, 1))

    return sched


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    def sched(step: Count):
        warm = _min1((step + 1) / max(warmup_steps, 1))
        prog = _clip01((step - warmup_steps) / max(total_steps - warmup_steps, 1))
        return lr * warm * 0.5 * (1.0 + _cos(math.pi * prog))

    return sched


def cosine_decay_to_constant_with_warmup(
    lr: float, warmup_steps: int, total_steps: int, final_ratio: float = 0.05, decay_fraction: float = 1.0,
) -> Schedule:
    """Cosine decays over decay_fraction of the run, then holds final_ratio."""
    decay_steps = max(int((total_steps - warmup_steps) * decay_fraction), 1)

    def sched(step: Count):
        warm = _min1((step + 1) / max(warmup_steps, 1))
        prog = _clip01((step - warmup_steps) / decay_steps)
        cos = 0.5 * (1.0 + _cos(math.pi * prog))
        if isinstance(prog, torch.Tensor):
            factor = torch.where(prog >= 1.0, final_ratio, cos * (1 - final_ratio) + final_ratio)
        else:
            factor = final_ratio if prog >= 1.0 else cos * (1 - final_ratio) + final_ratio
        return lr * warm * factor

    return sched


def _lr(learning_rate: Union[float, Schedule], count: Count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def _advance(count: Count, ok: Optional[torch.Tensor]) -> Count:
    """The count after this call: one more, or with a device flag one more
    where it is up, as a 0-dim tensor on its device from then on (made by a
    fill, not copied from the host, when it was an int, as after a restore:
    the schedules then read a tensor count either way, so a resumed run takes
    the same bits)."""
    if ok is None:
        return count + 1
    if not isinstance(count, torch.Tensor):
        count = torch.full((), count, dtype=torch.int64, device=ok.device)
    return count + ok.long()


def _gate(lr, ok: Optional[torch.Tensor]):
    """lr, or 0 where the flag is down."""
    return lr if ok is None else torch.where(ok, lr, 0.0)


def _add_scaled(p: torch.Tensor, x: torch.Tensor, a) -> None:
    """p += a * x for a number or a 0-dim tensor a."""
    if isinstance(a, torch.Tensor):
        p.add_(x * a)
    else:
        p.add_(x, alpha=a)


class _Keep:
    """Snapshot of some tensors, put back where a device flag is down (the
    per-tensor optimizers' form of the gate)."""

    def __init__(self, tensors: Sequence[torch.Tensor], ok: Optional[torch.Tensor]):
        self.ok, self.tensors = ok, list(tensors)
        self.saved = None if ok is None else [t.clone() for t in self.tensors]

    def restore(self) -> None:
        if self.ok is not None:
            for t, s in zip(self.tensors, self.saved):
                t.copy_(torch.where(self.ok, t, s))


# ---------------------------------------------------------------------------
# Optimizers


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (itself without one)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class Optimizer:
    """Base: ``init(params) -> state``; ``update(params, grads, state)`` in place."""

    LAYOUT: Dict[str, str] = {}

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        raise NotImplementedError

    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: Dict,
               ok: Optional[torch.Tensor] = None, shards=None) -> None:
        raise NotImplementedError

    def layout(self) -> Dict:
        """Each per-parameter list of the state: 'param' (the parameter's
        shape), 'rows' or 'cols' (CAME's factored statistics)."""
        return dict(self.LAYOUT)


class AdamW(Optimizer):
    """``optax.adamw``; with ``moment_dtype`` the low-memory form, whose
    moments are upcast, updated in f32 and stored back."""

    LAYOUT = {"mu": "param", "nu": "param"}

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, moment_dtype=None):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.moment_dtype = weight_decay, moment_dtype

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)  # noqa: E731
        return {"count": 0, "mu": [zeros(p) for p in params], "nu": [zeros(p) for p in params]}

    def update(self, params, grads, state, ok=None, shards=None):
        b1, b2 = self.b1, self.b2
        state["count"] = _advance(state["count"], ok)
        lr = _gate(_lr(self.learning_rate, state["count"] - 1), ok)  # the schedule at the count before this call
        m1, m2 = b1, b2
        if ok is None:
            bc1, bc2 = 1.0 - b1 ** state["count"], 1.0 - b2 ** state["count"]
        else:  # the gradients are 0 where the flag is down: the moments keep their bits (x1, + 0), the params too
            m1, m2 = torch.where(ok, b1, 1.0), torch.where(ok, b2, 1.0)
            count = state["count"].clamp_min(1)  # a skipped first step: no 0/0
            bc1, bc2 = 1.0 - b1**count, 1.0 - b2**count
        stored_mu, stored_nu = state["mu"], state["nu"]
        low = self.moment_dtype is not None
        mu = [m.float() for m in stored_mu] if low else stored_mu
        nu = [v.float() for v in stored_nu] if low else stored_nu
        grads = [g.float() for g in grads] if low else grads
        torch._foreach_mul_(mu, m1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, m2)
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

    LAYOUT = {"mu": "param"}

    def __init__(self, learning_rate, b1=0.9, b2=0.99, weight_decay=0.0, mu_dtype=None):
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.weight_decay, self.mu_dtype = weight_decay, mu_dtype

    def init(self, params):
        return {"count": 0, "mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params]}

    def update(self, params, grads, state, ok=None, shards=None):
        state["count"] = _advance(state["count"], ok)
        lr = _gate(_lr(self.learning_rate, state["count"] - 1), ok)
        for p, g, m in zip(params, grads, state["mu"]):
            keep = _Keep((p, m), ok)
            m32 = m.to(g.dtype)
            step = torch.sign((1.0 - self.b1) * g + self.b1 * m32)
            if self.weight_decay:
                step = step + self.weight_decay * p
            m.copy_(self.b2 * m32 + (1.0 - self.b2) * g)
            _add_scaled(p, step.to(p.dtype), -lr)
            keep.restore()


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

    LAYOUT = {"m": "param", "vr": "rows", "vc": "cols", "rr": "rows", "rc": "cols"}

    def _approx(self, r, c, mean0=None):
        # RMS-factored approximation: (r_i * c_j) / mean(r); a 2-D weight's r is sharded along its rows
        denom = (r.mean(dim=-1, keepdim=True) if mean0 is None else mean0(r)[None]).clamp_min(self.eps[0])
        return r[..., None] * c[..., None, :] / denom[..., None]

    def update(self, params, grads, state, ok=None, shards=None):
        b1, b2, b3 = self.betas
        eps1, eps2 = self.eps
        state["count"] = _advance(state["count"], ok)
        lr = _lr(self.learning_rate, state["count"])
        for i, (p, g) in enumerate(zip(params, grads)):
            m, vr, vc, rr, rc = (state[k][i] for k in ("m", "vr", "vc", "rr", "rc"))
            keep = _Keep((p, m, vr, vc, rr, rc), ok)
            factored = g.ndim >= 2
            mean, mean0 = torch.mean, None  # of the whole tensor; over dim 0 of a 2-D one
            if shards is not None:  # dim 0 is split over the group: sums over it, then the full size
                rows, group = shards.rows[i], shards.group
                numel = rows * math.prod(g.shape[1:])
                mean = lambda x: _sum(x.sum(), group) / numel  # noqa: E731
                if g.ndim == 2:
                    mean0 = lambda x: _sum(x.sum(dim=0), group) / rows  # noqa: E731
            if factored:
                g2 = g * g + eps1
                vr.mul_(b2).add_(g2.mean(dim=-1), alpha=1 - b2)
                vc.mul_(b2).add_(g2.mean(dim=-2) if mean0 is None else mean0(g2), alpha=1 - b2)
                u = g * torch.rsqrt(self._approx(vr, vc, mean0))
            else:
                vr.mul_(b2).add_(g * g + eps1, alpha=1 - b2)
                u = g * torch.rsqrt(vr)
            rms = torch.sqrt(mean(u * u) + eps1)  # update clipping by RMS
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            m.mul_(b1).add_(u, alpha=1 - b1)
            if factored:
                res = (u - m) ** 2 + eps2
                rr.mul_(b3).add_(res.mean(dim=-1), alpha=1 - b3)
                rc.mul_(b3).add_(res.mean(dim=-2) if mean0 is None else mean0(res), alpha=1 - b3)
                out = m * torch.rsqrt(self._approx(rr, rc, mean0))
            else:
                out = m
            if self.weight_decay:
                out = out + self.weight_decay * p
            _add_scaled(p, out, -lr)
            keep.restore()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, group=None) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: gradients scaled by max_norm / norm when
    the norm is at least max_norm. The factor stays on the device. With
    ``group`` the gradients are shards and the norm is over all of them."""
    norms = torch.stack(torch._foreach_norm(list(grads)))
    if group is not None:  # every rank's shard norms, whose norm is the global one
        size = dist.get_world_size(group)
        every = torch.empty(size * norms.numel(), dtype=norms.dtype, device=norms.device)
        dist.all_gather_into_tensor(every, norms, group=group)
        norms = every
    norm = torch.linalg.vector_norm(norms)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(list(grads), factor)


class Chain(Optimizer):
    """Global-norm clipping, then the optimizer, under ``optax.MultiSteps``
    when ``grad_accum > 1``."""

    def __init__(self, opt: Optimizer, grad_clip_norm: Optional[float], grad_accum: int):
        self.opt, self.grad_clip_norm, self.grad_accum = opt, grad_clip_norm, grad_accum

    def layout(self):
        return {"inner": self.opt.layout(), "acc_grads": "param"}

    def init(self, params):
        state = {"inner": self.opt.init(params)}
        if self.grad_accum > 1:
            state.update(mini_step=0, gradient_step=0, acc_grads=[torch.zeros_like(p) for p in params])
        return state

    def _inner(self, params, grads, state, ok=None, shards=None):
        if self.grad_clip_norm:
            grads = clip_by_global_norm(grads, self.grad_clip_norm, None if shards is None else shards.group)
        kw = {} if shards is None else {"shards": shards}
        self.opt.update(params, grads, state["inner"], ok=ok, **kw)

    @torch.no_grad()
    def update(self, params, grads, state, ok=None, shards=None):
        if self.grad_accum <= 1:
            return self._inner(params, grads, state, ok, shards)
        acc, n = state["acc_grads"], state["mini_step"]
        if ok is None:
            for a, g in zip(acc, grads):  # running mean of the gradients seen since the last update
                a.add_((g - a) / (n + 1))
            if n == self.grad_accum - 1:
                self._inner(params, acc, state, shards=shards)
                state["gradient_step"] += 1
                torch._foreach_zero_(acc)
            state["mini_step"] = (n + 1) % self.grad_accum
            return
        # the same on the device: the inner update runs on every call, gated by "the flag is up and this is
        # the k-th call", and the running mean and the counters move only where the flag is up
        n = torch.as_tensor(n, device=ok.device)
        for a, g in zip(acc, grads):
            a.add_((g - a) * (ok.float() / (n + 1)))
        fire = ok & (n == self.grad_accum - 1)
        self._inner(params, torch._foreach_mul(acc, fire.float()), state, fire, shards)
        state["gradient_step"] = state["gradient_step"] + fire.long()
        torch._foreach_mul_(acc, (~fire).float())
        state["mini_step"] = torch.where(ok, (n + 1) % self.grad_accum, n)


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
