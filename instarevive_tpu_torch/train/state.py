"""Train state with EMA (``instarevive_tpu/train/state.py``): a module's
parameters, their optimizer state, an EMA shadow with the LitEma warm-up
decay ``min(rate, (1 + n) / (10 + n))``, and the step count.

The state updates in place (JAX's returns a new one): ``apply_gradients``
changes the module's parameters, the optimizer state and the EMA. The step
and the EMA advance on every call, also on the calls between two updates of
an accumulating optimizer, as the JAX package's does under
``optax.MultiSteps``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from instarevive_tpu_torch.train.optim import Optimizer


class TrainState:
    def __init__(self, module: nn.Module, tx: Optimizer, ema: bool = True, ema_rate: float = 0.9999,
                 ema_dtype: Optional[torch.dtype] = None, ema_warmup: bool = True):
        """``ema_dtype`` (e.g. bf16) stores the EMA shadow compactly; the EMA
        update itself runs in f32 and casts back."""
        self.module, self.tx = module, tx
        self.names: List[str] = [n for n, p in module.named_parameters() if p.requires_grad]
        self.params: List[nn.Parameter] = [p for p in module.parameters() if p.requires_grad]
        self.step = 0
        self.opt_state = tx.init(self.params)
        self.ema_rate, self.ema_warmup = ema_rate, ema_warmup
        self.ema_params: Optional[List[torch.Tensor]] = None
        if ema:
            self.ema_params = [p.detach().to(ema_dtype or p.dtype, copy=True) for p in self.params]

    @classmethod
    def create(cls, module: nn.Module, tx: Optimizer, ema: bool = True, ema_rate: float = 0.9999,
               ema_dtype: Optional[torch.dtype] = None) -> "TrainState":
        return cls(module, tx, ema=ema, ema_rate=ema_rate, ema_dtype=ema_dtype)

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "TrainState":
        self.tx.update(self.params, list(grads), self.opt_state)
        self.step += 1
        if self.ema_params is not None:
            decay = self.ema_rate
            if self.ema_warmup:
                decay = min(self.ema_rate, (1.0 + self.step) / (10.0 + self.step))
            f32 = [e for e in self.ema_params if e.dtype == torch.float32]
            if f32:
                torch._foreach_mul_(f32, decay)
                torch._foreach_add_(f32, [p for e, p in zip(self.ema_params, self.params) if e.dtype == torch.float32],
                                    alpha=1.0 - decay)
            for e, p in zip(self.ema_params, self.params):
                if e.dtype != torch.float32:
                    e.copy_(e.float() * decay + p.float() * (1.0 - decay))
        return self

    def ema_state_dict(self) -> Optional[Dict[str, torch.Tensor]]:
        if self.ema_params is None:
            return None
        return dict(zip(self.names, self.ema_params))
