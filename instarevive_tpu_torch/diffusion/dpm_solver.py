"""DPM-Solver / DPM-Solver++ on a discrete VP schedule
(``instarevive_tpu/diffusion/dpm_solver.py``). Two surfaces:

  * ``dpm_solver_pp_2m``: the guided-sampling hot path (order-2 multistep
    DPM-Solver++ on a time-uniform grid);
  * ``dpm_solver_sample``: the family: orders 1-3, multistep / singlestep /
    singlestep_fixed, dpmsolver and dpmsolver++, dpmsolver / taylor
    expansions, time_uniform / logSNR / time_quadratic grids, dynamic
    thresholding, lower_order_final, denoise_to_zero.

Every grid point and coefficient is computed before the loop: for
``dpm_solver_pp_2m`` as float32 tensors on the host in the JAX package's
order of operations (its float32 ``linspace`` and ``interp``), moved to the
device in one copy that the host does not wait for; for ``dpm_solver_sample`` in host float64 (``_HostNS``),
entering each update as a Python float. A step is then model calls and
elementwise updates with nothing read back. ``model_fn(x, t)`` predicts
epsilon at the discrete time t = (t_cont - 1/N) * 1000, a float32 tensor
(B,) on x's device; classifier-free guidance wraps ``model_fn``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule, host_to

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class VPGrid(NamedTuple):
    t_grid: torch.Tensor  # (T,) continuous times 1/T..1, f32 on the host
    log_alpha_grid: torch.Tensor  # 0.5 * log(alphas_cumprod), f32
    total_n: int


def vp_grid(sched: DiffusionSchedule) -> VPGrid:
    n = sched.num_timesteps
    t = np.arange(1, n + 1, dtype=np.float64) / n
    log_alpha = 0.5 * np.log(sched.alphas_cumprod.cpu().numpy().astype(np.float64))
    return VPGrid(torch.tensor(t, dtype=torch.float32), torch.tensor(log_alpha, dtype=torch.float32), n)


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """float32 ``jnp.linspace`` with its endpoint: start (1 - s) + stop s with
    s = i / (num - 1), the last point stop itself."""
    start_t, stop_t = torch.tensor(start, dtype=torch.float32), torch.tensor(stop, dtype=torch.float32)
    step = torch.arange(num - 1, dtype=torch.float32) / torch.tensor(num - 1, dtype=torch.float32)
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t[None]])


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` over increasing, distinct ``xp``: piecewise-linear,
    constant beyond the ends."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    f = fp[i - 1] + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (fp[i] - fp[i - 1])
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _alpha_sigma_lambda(grid: VPGrid, t: torch.Tensor):
    log_a = _interp(t, grid.t_grid, grid.log_alpha_grid)
    alpha = torch.exp(log_a)
    sigma = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return alpha, sigma, log_a - torch.log(sigma)


def dpm_solver_pp_2m(model_fn: ModelFn, sched: DiffusionSchedule, x: torch.Tensor, steps: int = 20,
                     t_start: float = 1.0, t_end: float = None, clip_denoised: bool = False) -> torch.Tensor:
    """Sample with DPM-Solver++(2M) on a time-uniform grid: a first-order
    step, then ``steps`` - 1 second-order multistep updates; ``steps`` model
    calls in all."""
    grid = vp_grid(sched)
    t_end = t_end if t_end is not None else 1.0 / grid.total_n
    ts = _linspace(t_start, t_end, steps + 1)
    alpha, sigma, lam = _alpha_sigma_lambda(grid, ts)
    t_in = (ts - 1.0 / grid.total_n) * 1000.0
    h = lam[1:] - lam[:-1]
    decay = sigma[1:] / sigma[:-1]  # x's factor over each step
    phi = alpha[1:] * torch.expm1(-h)  # the data prediction's factor
    w = torch.zeros(steps)  # weight of the previous x0 in the second-order term
    w[1:] = 1.0 / (2.0 * (h[:-1] / h[1:]))
    # one copy to the device: per point (t_in, alpha, sigma), per step (decay, phi, 1 + w, w)
    table = host_to(torch.stack([t_in[:-1], alpha[:-1], sigma[:-1], decay, phi, 1.0 + w, w]), x.device)
    b = x.shape[0]

    def x0_pred(x, i):
        eps = model_fn(x, table[0, i].expand(b))
        x0 = (x - table[2, i] * eps) / table[1, i]
        return x0.clamp(-1.0, 1.0) if clip_denoised else x0

    x0_prev = x0_pred(x, 0)
    x = table[3, 0] * x - table[4, 0] * x0_prev
    for i in range(1, steps):
        x0_cur = x0_pred(x, i)
        d = table[5, i] * x0_cur - table[6, i] * x0_prev
        x = table[3, i] * x - table[4, i] * d
        x0_prev = x0_cur
    return x


# ---------------------------------------------------------------------------
# the solver family (orders 1-3, multistep / singlestep, dpmsolver / ++)
# ---------------------------------------------------------------------------


class _HostNS:
    """Host float64 NoiseScheduleVP('discrete'): piecewise-linear log-alpha(t)
    with the -5.1 log-SNR clip, and the inverse lambda map."""

    def __init__(self, sched: DiffusionSchedule):
        acp = sched.alphas_cumprod.cpu().numpy().astype(np.float64)
        log_alphas = 0.5 * np.log(acp)
        log_sigmas = 0.5 * np.log1p(-np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        idx = int(np.searchsorted(lambs[::-1], -5.1))
        if idx > 0:
            log_alphas = log_alphas[:-idx]
        self.total_n = len(log_alphas)
        self.t_array = np.arange(1, self.total_n + 1, dtype=np.float64) / self.total_n
        self.log_alpha_array = log_alphas
        self.T = 1.0

    def log_mean_coeff(self, t):
        return np.interp(t, self.t_array, self.log_alpha_array)

    def alpha(self, t) -> float:
        return float(np.exp(self.log_mean_coeff(t)))

    def std(self, t) -> float:
        return float(np.sqrt(1.0 - np.exp(2.0 * self.log_mean_coeff(t))))

    def lam(self, t) -> float:
        la = self.log_mean_coeff(t)
        return float(la - 0.5 * np.log1p(-np.exp(2.0 * la)))

    def inverse_lambda(self, lamb) -> float:
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * np.asarray(lamb, np.float64))
        return float(np.interp(log_alpha, self.log_alpha_array[::-1], self.t_array[::-1]))


def _time_grid(ns: _HostNS, skip_type: str, t_T: float, t_0: float, n: int) -> np.ndarray:
    if skip_type == "logSNR":
        lams = np.linspace(ns.lam(t_T), ns.lam(t_0), n + 1)
        return np.array([ns.inverse_lambda(lm) for lm in lams])
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, n + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T**0.5, t_0**0.5, n + 1) ** 2
    raise ValueError(f"unknown skip_type {skip_type}")


def _dynamic_threshold(x0: torch.Tensor, ratio: float, max_val: float) -> torch.Tensor:
    """Imagen dynamic thresholding: clip each sample at the ``ratio``
    quantile of |x0| (at least ``max_val``) and rescale by it."""
    b = x0.shape[0]
    s = torch.quantile(x0.reshape(b, -1).abs(), ratio, dim=1)
    s = torch.clamp(s, min=max_val).reshape((b,) + (1,) * (x0.ndim - 1))
    return torch.clamp(x0, min=-s, max=s) / s


def dpm_solver_sample(model_fn: ModelFn, sched: DiffusionSchedule, x: torch.Tensor, steps: int = 20,
                      order: int = 2, method: str = "multistep", algorithm: str = "dpmsolver++",
                      skip_type: str = "time_uniform", solver_type: str = "dpmsolver", t_start: float = None,
                      t_end: float = None, lower_order_final: bool = True, denoise_to_zero: bool = False,
                      dynamic_thresholding: bool = False, thresholding_ratio: float = 0.995,
                      thresholding_max_val: float = 1.0) -> torch.Tensor:
    """The DPM-Solver(++) family. ``model_fn(x, t_discrete) -> eps``."""
    if order not in (1, 2, 3) or algorithm not in ("dpmsolver", "dpmsolver++"):
        raise ValueError(f"order {order}, algorithm {algorithm!r}")
    if solver_type not in ("dpmsolver", "taylor"):
        raise ValueError(f"solver_type {solver_type!r}")
    ns = _HostNS(sched)
    t_0 = 1.0 / ns.total_n if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    b = x.shape[0]
    pp = algorithm == "dpmsolver++"
    taylor = solver_type == "taylor"

    def raw_eps(x, t):
        return model_fn(x, torch.full((b,), float((t - 1.0 / ns.total_n) * 1000.0), device=x.device))

    def mf(x, t):
        """data prediction (++) or noise prediction"""
        eps = raw_eps(x, t)
        if not pp:
            return eps
        x0 = (x - ns.std(t) * eps) / ns.alpha(t)
        if dynamic_thresholding:
            x0 = _dynamic_threshold(x0, thresholding_ratio, thresholding_max_val)
        return x0

    def first_update(x, s, t, model_s):
        h = ns.lam(t) - ns.lam(s)
        if pp:
            return (ns.std(t) / ns.std(s)) * x - float(ns.alpha(t) * np.expm1(-h)) * model_s
        return (ns.alpha(t) / ns.alpha(s)) * x - float(ns.std(t) * np.expm1(h)) * model_s

    def singlestep_second(x, s, t, r1=0.5):
        lam_s, lam_t = ns.lam(s), ns.lam(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        model_s = mf(x, s)
        if pp:
            x_s1 = (ns.std(s1) / ns.std(s)) * x - float(ns.alpha(s1) * np.expm1(-r1 * h)) * model_s
            model_s1 = mf(x_s1, s1)
            phi_1 = float(np.expm1(-h))
            lead = (ns.std(t) / ns.std(s)) * x - (ns.alpha(t) * phi_1) * model_s
            if not taylor:
                return lead - ((0.5 / r1) * ns.alpha(t) * phi_1) * (model_s1 - model_s)
            return lead + ((1.0 / r1) * ns.alpha(t) * (phi_1 / h + 1.0)) * (model_s1 - model_s)
        x_s1 = (ns.alpha(s1) / ns.alpha(s)) * x - float(ns.std(s1) * np.expm1(r1 * h)) * model_s
        model_s1 = mf(x_s1, s1)
        phi_1 = float(np.expm1(h))
        lead = (ns.alpha(t) / ns.alpha(s)) * x - (ns.std(t) * phi_1) * model_s
        if not taylor:
            return lead - ((0.5 / r1) * ns.std(t) * phi_1) * (model_s1 - model_s)
        return lead - ((1.0 / r1) * ns.std(t) * (phi_1 / h - 1.0)) * (model_s1 - model_s)

    def singlestep_third(x, s, t, r1=1.0 / 3.0, r2=2.0 / 3.0):
        lam_s, lam_t = ns.lam(s), ns.lam(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        s2 = ns.inverse_lambda(lam_s + r2 * h)
        model_s = mf(x, s)
        if pp:
            phi_11, phi_12, phi_1 = float(np.expm1(-r1 * h)), float(np.expm1(-r2 * h)), float(np.expm1(-h))
            phi_22 = float(np.expm1(-r2 * h)) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            x_s1 = (ns.std(s1) / ns.std(s)) * x - (ns.alpha(s1) * phi_11) * model_s
            model_s1 = mf(x_s1, s1)
            x_s2 = ((ns.std(s2) / ns.std(s)) * x - (ns.alpha(s2) * phi_12) * model_s
                    + ((r2 / r1) * ns.alpha(s2) * phi_22) * (model_s1 - model_s))
            model_s2 = mf(x_s2, s2)
            lead = (ns.std(t) / ns.std(s)) * x - (ns.alpha(t) * phi_1) * model_s
            if not taylor:
                return lead + ((1.0 / r2) * ns.alpha(t) * phi_2) * (model_s2 - model_s)
            d1_0 = (1.0 / r1) * (model_s1 - model_s)
            d1_1 = (1.0 / r2) * (model_s2 - model_s)
            d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
            d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
            return lead + (ns.alpha(t) * phi_2) * d1 - (ns.alpha(t) * phi_3) * d2
        phi_11, phi_12, phi_1 = float(np.expm1(r1 * h)), float(np.expm1(r2 * h)), float(np.expm1(h))
        phi_22 = float(np.expm1(r2 * h)) / (r2 * h) - 1.0
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        x_s1 = (ns.alpha(s1) / ns.alpha(s)) * x - (ns.std(s1) * phi_11) * model_s
        model_s1 = mf(x_s1, s1)
        x_s2 = ((ns.alpha(s2) / ns.alpha(s)) * x - (ns.std(s2) * phi_12) * model_s
                - ((r2 / r1) * ns.std(s2) * phi_22) * (model_s1 - model_s))
        model_s2 = mf(x_s2, s2)
        lead = (ns.alpha(t) / ns.alpha(s)) * x - (ns.std(t) * phi_1) * model_s
        if not taylor:
            return lead - ((1.0 / r2) * ns.std(t) * phi_2) * (model_s2 - model_s)
        d1_0 = (1.0 / r1) * (model_s1 - model_s)
        d1_1 = (1.0 / r2) * (model_s2 - model_s)
        d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
        d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
        return lead - (ns.std(t) * phi_2) * d1 - (ns.std(t) * phi_3) * d2

    def multistep_second(x, models, ts_prev, t):
        m1, m0 = models[-2], models[-1]
        t1, t0 = ts_prev[-2], ts_prev[-1]
        h0 = ns.lam(t0) - ns.lam(t1)
        h = ns.lam(t) - ns.lam(t0)
        r0 = h0 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        if pp:
            phi_1 = float(np.expm1(-h))
            lead = (ns.std(t) / ns.std(t0)) * x - (ns.alpha(t) * phi_1) * m0
            if not taylor:
                return lead - (0.5 * ns.alpha(t) * phi_1) * d1_0
            return lead + (ns.alpha(t) * (phi_1 / h + 1.0)) * d1_0
        phi_1 = float(np.expm1(h))
        lead = (ns.alpha(t) / ns.alpha(t0)) * x - (ns.std(t) * phi_1) * m0
        if not taylor:
            return lead - (0.5 * ns.std(t) * phi_1) * d1_0
        return lead - (ns.std(t) * (phi_1 / h - 1.0)) * d1_0

    def multistep_third(x, models, ts_prev, t):
        m2, m1, m0 = models[-3], models[-2], models[-1]
        t2, t1, t0 = ts_prev[-3], ts_prev[-2], ts_prev[-1]
        h1 = ns.lam(t1) - ns.lam(t2)
        h0 = ns.lam(t0) - ns.lam(t1)
        h = ns.lam(t) - ns.lam(t0)
        r0, r1 = h0 / h, h1 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        d1_1 = (1.0 / r1) * (m1 - m2)
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
        if pp:
            phi_1 = float(np.expm1(-h))
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            return ((ns.std(t) / ns.std(t0)) * x - (ns.alpha(t) * phi_1) * m0
                    + (ns.alpha(t) * phi_2) * d1 - (ns.alpha(t) * phi_3) * d2)
        phi_1 = float(np.expm1(h))
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        return ((ns.alpha(t) / ns.alpha(t0)) * x - (ns.std(t) * phi_1) * m0
                - (ns.std(t) * phi_2) * d1 - (ns.std(t) * phi_3) * d2)

    def multistep_update(x, models, ts_prev, t, step_order):
        if step_order == 1:
            return first_update(x, ts_prev[-1], t, models[-1])
        if step_order == 2:
            return multistep_second(x, models, ts_prev, t)
        return multistep_third(x, models, ts_prev, t)

    if method == "multistep":
        if steps < order:
            raise ValueError(f"multistep needs steps >= order, got {steps} < {order}")
        tg = _time_grid(ns, skip_type, t_T, t_0, steps)
        ts_prev = [tg[0]]
        models = [mf(x, tg[0])]
        for step in range(1, order):  # lower-order warm-up
            t = tg[step]
            x = multistep_update(x, models, ts_prev, t, step)
            ts_prev.append(t)
            models.append(mf(x, t))
        for step in range(order, steps + 1):
            t = tg[step]
            step_order = min(order, steps + 1 - step) if lower_order_final else order
            x = multistep_update(x, models, ts_prev, t, step_order)
            ts_prev = ts_prev[1:] + [t]
            if step < steps:
                models = models[1:] + [mf(x, t)]
    elif method in ("singlestep", "singlestep_fixed"):
        if method == "singlestep":  # the DPM-Solver-fast order schedule
            if order == 3:
                K = steps // 3 + 1
                orders = {0: [3] * (K - 2) + [2, 1], 1: [3] * (K - 1) + [1],
                          2: [3] * (K - 1) + [2]}[steps % 3]
            elif order == 2:
                K = steps // 2 if steps % 2 == 0 else steps // 2 + 1
                orders = [2] * (steps // 2) + ([1] if steps % 2 else [])
            else:
                K, orders = steps, [1] * steps
            if skip_type == "logSNR":  # the grid over the K macro-steps
                tg_outer = _time_grid(ns, skip_type, t_T, t_0, K)
            else:
                tg_outer = _time_grid(ns, skip_type, t_T, t_0, steps)[np.cumsum([0] + orders)]
        else:
            K = steps // order
            orders = [order] * K
            tg_outer = _time_grid(ns, skip_type, t_T, t_0, K)
        for i, o in enumerate(orders):
            s, t = tg_outer[i], tg_outer[i + 1]
            if o == 1:
                x = first_update(x, s, t, mf(x, s))
                continue
            # the intermediate ratios from an inner grid of the same skip type
            lam_in = [ns.lam(u) for u in _time_grid(ns, skip_type, s, t, o)]
            h = lam_in[-1] - lam_in[0]
            if o == 2:
                x = singlestep_second(x, s, t, r1=(lam_in[1] - lam_in[0]) / h)
            else:
                x = singlestep_third(x, s, t, r1=(lam_in[1] - lam_in[0]) / h, r2=(lam_in[2] - lam_in[0]) / h)
    else:
        raise ValueError(f"unknown method {method}")

    if denoise_to_zero:  # through the data prediction, thresholding included
        x = (x - ns.std(t_0) * raw_eps(x, t_0)) / ns.alpha(t_0)
        if dynamic_thresholding:
            x = _dynamic_threshold(x, thresholding_ratio, thresholding_max_val)
    return x
