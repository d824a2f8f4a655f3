"""Train state with EMA (``instarevive_tpu/train/state.py``): a module's
parameters, their optimizer state, an EMA shadow with the LitEma warm-up
decay ``min(rate, (1 + n) / (10 + n))``, and the step count.

The state updates in place (JAX's returns a new one): ``apply_gradients``
changes the module's parameters, the optimizer state and the EMA. The step
and the EMA advance on every call, also on the calls between two updates of
an accumulating optimizer, as the JAX package's does under
``optax.MultiSteps``; a call gated by a device flag (``utils.debug.nan_guard``)
advances them only where the flag is up.

Under FSDP2 (``parallel/mesh.TrainMesh``) the module's parameters are
sharded: ``params`` are then this rank's shards (views that write the
parameters), the optimizer state and the EMA are kept shard by shard, the
gradients come from ``grad_fn``, and the optimizer's cross-shard reductions
go over ``shard_group``; the finite-gradient flag is agreed over
``flag_group`` (every rank of the run). ``module_state_dict``,
``opt_state_full`` and ``ema_state_dict`` (collectives then) give the
one-card layout, and ``load_module_state_dict``, ``local_opt_state`` and
``load_ema`` take it, whatever the world size.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from instarevive_tpu_torch.parallel.mesh import all_true, gather_full, local_chunk, local_tensor
from instarevive_tpu_torch.train.optim import Optimizer


class TrainState:
    def __init__(self, module: nn.Module, tx: Optimizer, ema: bool = True, ema_rate: float = 0.9999,
                 ema_dtype: Optional[torch.dtype] = None, ema_warmup: bool = True):
        """``ema_dtype`` (e.g. bf16) stores the EMA shadow compactly; the EMA
        update itself runs in f32 and casts back."""
        self.module, self.tx = module, tx
        self.names: List[str] = [n for n, p in module.named_parameters() if p.requires_grad]
        self.module_params: List[nn.Parameter] = [p for p in module.parameters() if p.requires_grad]
        self.grad_fn: Optional[Callable[[torch.Tensor], List[torch.Tensor]]] = None
        self.shard_group = self.flag_group = None
        self.step = 0
        self.opt_state = tx.init(self.params)
        self.ema_rate, self.ema_warmup = ema_rate, ema_warmup
        self.ema_params: Optional[List[torch.Tensor]] = None
        if ema:
            self.ema_params = [p.detach().to(ema_dtype or p.dtype, copy=True) for p in self.params]

    @property
    def params(self) -> List[torch.Tensor]:
        """The trained parameters, or under FSDP2 this rank's shards of them."""
        return [local_tensor(p) for p in self.module_params]

    def gradients(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """d loss / d ``params`` (zeros for a parameter the loss does not
        reach), averaged over the data-parallel ranks when there are several."""
        if self.grad_fn is not None:
            return self.grad_fn(loss)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]

    def agree(self, ok: torch.Tensor) -> torch.Tensor:
        """A finite-gradient flag that is up only where it is up on every
        shard (each rank saw its own shard of the gradients)."""
        return ok if self.flag_group is None else all_true(ok, self.flag_group)

    @classmethod
    def create(cls, module: nn.Module, tx: Optimizer, ema: bool = True, ema_rate: float = 0.9999,
               ema_dtype: Optional[torch.dtype] = None) -> "TrainState":
        return cls(module, tx, ema=ema, ema_rate=ema_rate, ema_dtype=ema_dtype)

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor], ok: Optional[torch.Tensor] = None) -> "TrainState":
        """One optimizer step, the step count and the EMA. With ``ok`` (a 0-dim
        bool tensor; the gradients finite, e.g. zeroed where it is down) all
        of it is gated on the device: where ``ok`` is False the parameters,
        moments, step and EMA keep their bits. The step and the optimizer's
        count then become 0-dim tensors on the device."""
        params = self.params
        shards = None
        if self.shard_group is not None:
            shards = Shards(self.shard_group, [p.shape[0] for p in self.module_params])
        kw = {} if shards is None else {"shards": shards}
        if ok is None:
            self.tx.update(params, list(grads), self.opt_state, **kw)
        else:
            self.tx.update(params, list(grads), self.opt_state, ok=ok, **kw)
        self.step = self.step + (1 if ok is None else ok.long())
        if self.ema_params is not None:
            decay = self.ema_rate
            if ok is None:
                if self.ema_warmup:
                    decay = min(self.ema_rate, (1.0 + self.step) / (10.0 + self.step))
            else:
                if self.ema_warmup:
                    decay = torch.clamp((1.0 + self.step) / (10.0 + self.step), max=self.ema_rate)
                decay = torch.where(ok, decay, 1.0)  # 1: the shadow keeps its bits
            f32 = [e for e in self.ema_params if e.dtype == torch.float32]
            if f32:
                src = [p for e, p in zip(self.ema_params, params) if e.dtype == torch.float32]
                torch._foreach_mul_(f32, decay)
                if ok is None:
                    torch._foreach_add_(f32, src, alpha=1.0 - decay)
                else:
                    torch._foreach_add_(f32, torch._foreach_mul(src, 1.0 - decay))
            for e, p in zip(self.ema_params, params):
                if e.dtype != torch.float32:
                    e.copy_(e.float() * decay + p.float() * (1.0 - decay))
        return self

    def ema_state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        if self.ema_params is None:
            return None
        return dict(zip(self.names, (gather_full(e, p) for e, p in zip(self.ema_params, self.module_params))))

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's state dict in the one-card layout (a collective under
        FSDP2)."""
        return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v).detach()
                for k, v in self.module.state_dict().items()}

    def opt_state_full(self) -> Dict:
        """The optimizer state in the one-card layout (a collective under FSDP2)."""
        return _map_layout(self.opt_state, self.tx.layout(), self.module_params, gather_full)

    @torch.no_grad()
    def load_module_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a one-card state dict, each sharded parameter taking its chunk."""
        own = dict(self.module.named_parameters())
        own.update(self.module.named_buffers())
        missing = sorted(set(own) - set(sd))
        unexpected = sorted(set(sd) - set(own))
        if missing or unexpected:
            raise KeyError(f"state dict: missing {missing[:10]}, unexpected {unexpected[:10]}")
        for name, t in own.items():
            part = local_chunk(sd[name], t)
            dst = local_tensor(t)
            if part.shape != dst.shape:
                raise ValueError(f"{name}: shard {tuple(dst.shape)}, checkpoint chunk {tuple(part.shape)}")
            dst.copy_(part)

    def load_ema(self, ema: Dict[str, torch.Tensor]) -> None:
        for name, e, p in zip(self.names, self.ema_params, self.module_params):
            e.copy_(local_chunk(ema[name], p))

    def local_opt_state(self, tree: Dict) -> Dict:
        """A one-card optimizer-state tree cut to this rank's shards."""
        return _map_layout(tree, self.tx.layout(), self.module_params, local_chunk)


class Shards:
    """What the optimizer needs of FSDP2's layout: the group the shards are
    spread over and each parameter's full size along its sharded dim 0."""

    def __init__(self, group, rows: Sequence[int]):
        self.group, self.rows = group, list(rows)


def _map_layout(tree, layout, module_params, fn):
    """``fn(tensor, param, sharded)`` on each per-parameter list of an
    optimizer-state tree, as ``Optimizer.layout`` describes its keys: 'param'
    (the parameter's shape), 'rows' (dim 0 kept) or 'cols' (CAME's column
    statistics: dim 0 kept only for a parameter of 3 dims or more)."""
    out = {}
    for key, value in tree.items():
        kind = layout.get(key)
        if isinstance(value, dict):
            out[key] = _map_layout(value, layout.get(key, {}), module_params, fn)
        elif kind is not None and isinstance(value, list):
            out[key] = [fn(t, p, kind != "cols" or p.ndim >= 3) for t, p in zip(value, module_params)]
        else:
            out[key] = value
    return out
