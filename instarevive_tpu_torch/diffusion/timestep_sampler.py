"""Timestep samplers for training (``instarevive_tpu/diffusion/timestep_sampler.py``).

The uniform sampler, and the loss-second-moment importance sampler whose
state (a ring buffer of the last ``history_per_term`` losses at every
timestep, and how many each holds) rides the train step as a plain carry:
a dict of two tensors on the device, which the checkpoint saves as it is.

Nothing here reads a value back from the device: the weights fall back to
uniform by ``torch.where`` until every timestep's buffer is full, the sample
is ``torch.multinomial`` on the device, and the update writes each of the
batch's losses in turn (as the JAX package's ``fori_loop`` does, so two
samples at one timestep land in order) by index ops. Draws come from an
explicit ``torch.Generator``, or ``t`` is handed in.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

State = Dict[str, torch.Tensor]  # {"history": (T, H) f32, "counts": (T,) int64}


def uniform_sample_t(generator: Optional[torch.Generator], batch: int, num_timesteps: int,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, weights): t uniform in [0, T), unit weights."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)
    return t, torch.ones(batch, device=device)


def loss_second_moment_init(num_timesteps: int, history_per_term: int = 10, device=None) -> State:
    return {"history": torch.zeros(num_timesteps, history_per_term, device=device),
            "counts": torch.zeros(num_timesteps, dtype=torch.int64, device=device)}


def loss_second_moment_weights(state: State, uniform_prob: float = 0.001) -> torch.Tensor:
    """Importance weights ~ sqrt(E[loss^2]) mixed with uniform; uniform until
    every timestep holds a full history."""
    hist = state["history"]
    warmed = (state["counts"] >= hist.shape[1]).all()
    w = torch.sqrt(torch.mean(hist**2, dim=-1))
    w = w / torch.clamp(w.sum(), min=1e-12)
    w = w * (1 - uniform_prob) + uniform_prob / hist.shape[0]
    return torch.where(warmed, w, torch.full_like(w, 1.0 / w.shape[0]))


def loss_second_moment_sample(generator: Optional[torch.Generator], state: State, batch: int,
                              t: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, weights 1 / (T p[t])); t drawn with replacement from p, or handed in."""
    p = loss_second_moment_weights(state)
    if t is None:
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


def loss_second_moment_update(state: State, t: torch.Tensor, losses: torch.Tensor) -> State:
    """Ring-buffer insert of per-sample losses at their timesteps: while a
    row is not full the loss goes to the next free slot, once full the row
    shifts left and the loss goes last. Returns a new state."""
    hist, counts = state["history"], state["counts"]
    hpt = hist.shape[1]
    losses = losses.detach().to(hist.dtype)
    for i in range(t.shape[0]):
        ti = t[i:i + 1].to(hist.device)
        loss = losses[i:i + 1].view(1, 1)
        row, c = hist.index_select(0, ti), counts.index_select(0, ti)
        full = (c >= hpt).view(1, 1)
        shifted = torch.cat([row[:, 1:], loss], dim=1)
        written = row.scatter(1, torch.clamp(c, max=hpt - 1).view(1, 1), loss)
        hist = hist.index_copy(0, ti, torch.where(full, shifted, written))
        counts = counts.index_copy(0, ti, torch.clamp(c + 1, max=hpt))
    return {"history": hist, "counts": counts}
