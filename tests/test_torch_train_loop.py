"""``test_dmd_loop_learns`` of ``tests/test_torch_train.py``, in a file of its
own so that the test runner's ``--dist loadfile`` can put it on another
worker than the rest of that file: 120 DMD steps of the port's trainer at
batch 8 on the tiny DiT; the generator's regression error must fall below
0.6 of its first value, and the EMA must track but lag."""

import math

import numpy as np
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

from instarevive_tpu_torch.diffusion.one_step import eps_to_x0
from instarevive_tpu_torch.diffusion.schedules import make_schedule
from test_torch_train import DIT, _fn, _loop, _t


def test_dmd_loop_learns():
    sched = make_schedule("linear", 1000)
    states, step, gen = _loop(DIT, 2e-4, 20, batch=8)
    y = torch.zeros(8, 8, 32)
    rng = np.random.default_rng(1)
    batch = {"noise": _t(rng.standard_normal((8, 8, 8, 4), dtype=np.float32)),
             "latent": _t(0.3 * rng.standard_normal((8, 8, 8, 4), dtype=np.float32))}
    generator = torch.Generator().manual_seed(3)
    first = None
    for i in range(120):
        m = step(*states, batch, generator, {"y": y})
        if i == 0:
            first = float(m["regression"])
    t = torch.full((8,), 400)
    with torch.no_grad():
        x0 = eps_to_x0(sched, _fn(gen)(batch["noise"], t, y=y), batch["noise"], t)
    final = float(torch.mean((x0 - batch["latent"]) ** 2))
    assert math.isfinite(final) and final < first * 0.6, (first, final)
    assert not torch.allclose(states[0].ema_params[0], states[0].params[0])  # the EMA tracks but lags
