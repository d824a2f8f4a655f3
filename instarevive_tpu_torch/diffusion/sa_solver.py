"""SA-Solver: the stochastic Adams predictor-corrector
(``instarevive_tpu/diffusion/sa_solver.py``): Lagrange-interpolated
exponential integrals, an Adams-Bashforth predictor and an Adams-Moulton
corrector in PEC or PECE mode, the 'few_steps' variant with the order-2
rescaling of its Appendix D and 'more_steps' with a final denoise to zero;
data- and noise-prediction forms; time, logSNR and karras grids.

Every schedule quantity, Lagrange coefficient and exponential integral is a
host float64 number computed from the static grid and tau, so a step is model
calls, elementwise updates and one normal draw on the device, from an explicit
generator or handed in (``noise_seq``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from instarevive_tpu_torch.diffusion.dpm_solver import _dynamic_threshold, _HostNS
from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule


def _coef_exp_neg(order: int, a: float, b: float) -> float:
    """The integral of exp(-x) x^order from a to b."""
    if order == 0:
        return math.exp(-b) * (math.exp(b - a) - 1.0)
    if order == 1:
        return math.exp(-b) * ((a + 1.0) * math.exp(b - a) - (b + 1.0))
    if order == 2:
        return math.exp(-b) * ((a**2 + 2 * a + 2) * math.exp(b - a) - (b**2 + 2 * b + 2))
    return math.exp(-b) * ((a**3 + 3 * a**2 + 6 * a + 6) * math.exp(b - a) - (b**3 + 3 * b**2 + 6 * b + 6))


def _coef_exp_pos(order: int, a: float, b: float, tau: float) -> float:
    """The integral of exp(x (1 + tau^2)) x^order from a to b."""
    s = 1.0 + tau**2
    bc, ac = s * b, s * a
    if order == 0:
        return math.exp(bc) * (1.0 - math.exp(-(bc - ac))) / s
    if order == 1:
        return math.exp(bc) * ((bc - 1.0) - (ac - 1.0) * math.exp(-(bc - ac))) / s**2
    if order == 2:
        return math.exp(bc) * ((bc**2 - 2 * bc + 2) - (ac**2 - 2 * ac + 2) * math.exp(-(bc - ac))) / s**3
    return (math.exp(bc) * ((bc**3 - 3 * bc**2 + 6 * bc - 6) - (ac**3 - 3 * ac**2 + 6 * ac - 6) * math.exp(-(bc - ac)))
            / s**4)


def _lagrange_coef(order: int, lams: Sequence[float]):
    """Monomial coefficients (highest first) of the Lagrange basis
    polynomials through ``lams``, order 0-3."""
    if order != len(lams) - 1:
        raise ValueError(f"{len(lams)} points for order {order}")
    if order == 0:
        return [[1.0]]
    out = []
    for i in range(order + 1):
        denom = 1.0
        others = []
        for j in range(order + 1):
            if j != i:
                denom *= lams[i] - lams[j]
                others.append(lams[j])
        coeffs = [1.0]  # prod (x - others), expanded
        for o in others:
            coeffs = coeffs + [0.0]
            for k in range(len(coeffs) - 1, 0, -1):
                coeffs[k] = coeffs[k] - o * coeffs[k - 1]
        out.append([c / denom for c in coeffs])
    return out


def _grad_coefs(order, a, b, lams, tau, predict_x0):
    lag = _lagrange_coef(order - 1, lams)
    coefs = []
    for i in range(order):
        c = 0.0
        for j in range(order):
            if predict_x0:
                c += lag[i][j] * _coef_exp_pos(order - 1 - j, a, b, tau)
            else:
                c += lag[i][j] * _coef_exp_neg(order - 1 - j, a, b)
        coefs.append(c)
    return coefs


def _sa_time_grid(ns: _HostNS, skip_type: str, t_T: float, t_0: float, n: int, order: int) -> np.ndarray:
    if skip_type == "time":
        return np.linspace(t_T ** (1.0 / order), t_0 ** (1.0 / order), n + 1) ** order
    if skip_type == "logSNR":
        lam_T, lam_0 = ns.lam(t_T), ns.lam(t_0)
        lams = lam_T + np.linspace(0.0, (lam_0 - lam_T) ** (1.0 / order), n + 1) ** order
        return np.array([ns.inverse_lambda(lm) for lm in lams])
    if skip_type == "karras":
        def edm_sigma(t):
            return ns.std(t) / ns.alpha(t)

        sigma_min = max(0.002, edm_sigma(1e-3))
        sigma_max = min(80.0, edm_sigma(1.0))
        sig = np.linspace(sigma_max ** (1 / 7), sigma_min ** (1 / 7), n + 1) ** 7
        return np.array([ns.inverse_lambda(np.log(1.0 / s)) for s in sig])
    raise ValueError(f"unknown skip_type {skip_type}")


def sa_solver_pc_sample(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: DiffusionSchedule,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    mode: str = "few_steps",
    tau: Union[float, Callable[[float], float]] = 1.0,
    steps: int = 20,
    predictor_order: int = 3,
    corrector_order: int = 4,
    pc_mode: str = "PEC",
    skip_type: str = "time",
    skip_order: int = 1,
    algorithm: str = "data_prediction",
    t_start: float = None,
    t_end: float = None,
    dynamic_thresholding: bool = False,
    thresholding_ratio: float = 0.995,
    thresholding_max_val: float = 1.0,
    noise_seq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SA-Solver predictor-corrector. ``model_fn(x, t_discrete) -> eps``.

    mode='few_steps': ``steps`` model calls, no final correction, the order-2
    rescaling; 'more_steps': corrects at the final step and denoises to zero.
    ``tau`` is a constant or a function of t (the stochasticity); tau = 0 is
    the ODE. The draw of step i is ``noise_seq[i]`` (steps + 1, *x.shape)
    when given, else a normal draw from ``generator`` on x's device.
    """
    if mode not in ("few_steps", "more_steps") or pc_mode not in ("PEC", "PECE"):
        raise ValueError(f"mode {mode!r}, pc_mode {pc_mode!r}")
    if algorithm not in ("data_prediction", "noise_prediction"):
        raise ValueError(f"algorithm {algorithm!r}")
    predict_x0 = algorithm == "data_prediction"
    few = mode == "few_steps"
    tau_fn = tau if callable(tau) else (lambda t, _v=float(tau): _v)
    ns = _HostNS(sched)
    t_0 = 1.0 / ns.total_n if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    b = x.shape[0]
    if steps < max(predictor_order, corrector_order - 1):
        raise ValueError(f"{steps} steps for predictor order {predictor_order}, corrector order {corrector_order}")
    tg = _sa_time_grid(ns, skip_type, t_T, t_0, steps, skip_order)

    def draw(i):
        if noise_seq is not None:
            return noise_seq[i]
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def raw_eps(xv, t):
        return model_fn(xv, torch.full((b,), float((t - 1.0 / ns.total_n) * 1000.0), device=xv.device))

    def mf(xv, t):
        eps = raw_eps(xv, t)
        if not predict_x0:
            return eps
        x0 = (xv - ns.std(t) * eps) / ns.alpha(t)
        if dynamic_thresholding:
            x0 = _dynamic_threshold(x0, thresholding_ratio, thresholding_max_val)
        return x0

    def update(order, xv, tau_t, models, t_prev, noise, t, corrector):
        """The Adams-Bashforth (predictor) and Adams-Moulton (corrector)
        update: one formula over two lambda grids."""
        lam_t = ns.lam(t)
        t0 = t_prev[-1]
        h = lam_t - ns.lam(t0)
        t_list = t_prev + [t] if corrector else t_prev
        lams = [ns.lam(t_list[-(i + 1)]) for i in range(order)]
        g = _grad_coefs(order, ns.lam(t0), lam_t, lams, tau_t, predict_x0)
        if few and predict_x0 and order == 2:  # the Appendix-D rescaling
            s2 = 1.0 + tau_t**2
            if corrector:
                adj = math.exp(s2 * lam_t) * (h / 2.0 - (h * s2 - 1.0 + math.exp(-s2 * h)) / (s2**2 * h))
            else:
                adj = (math.exp(s2 * lam_t) * (h**2 / 2.0 - (h * s2 - 1.0 + math.exp(-s2 * h)) / s2**2)
                       / (ns.lam(t_prev[-1]) - ns.lam(t_prev[-2])))
            g = [g[0] + adj, g[1] - adj] + g[2:]

        grad_part = 0.0
        for i in range(order):
            m = models[-(i + 1)]
            if predict_x0:
                grad_part = grad_part + ((1.0 + tau_t**2) * ns.std(t) * math.exp(-(tau_t**2) * lam_t) * g[i]) * m
            else:
                grad_part = grad_part + (-(1.0 + tau_t**2) * ns.alpha(t) * g[i]) * m
        if predict_x0:
            noise_coef = ns.std(t) * math.sqrt(max(1.0 - math.exp(-2.0 * tau_t**2 * h), 0.0))
            decay = math.exp(-(tau_t**2) * h) * (ns.std(t) / ns.std(t0))
        else:
            noise_coef = tau_t * ns.std(t) * math.sqrt(max(math.exp(2.0 * h) - 1.0, 0.0))
            decay = ns.alpha(t) / ns.alpha(t0)
        out = decay * xv + grad_part
        if noise_coef != 0.0:
            out = out + noise_coef * noise
        return out

    t_prev = [float(tg[0])]
    models = [mf(x, float(tg[0]))]

    warm_end = max(predictor_order, corrector_order - 1)
    for step in range(1, warm_end):
        t = float(tg[step])
        po = min(predictor_order, step)
        co = min(corrector_order, step + 1)
        noise = draw(step)
        x_p = update(po, x, tau_fn(t), models, t_prev, noise, t, corrector=False)
        models.append(mf(x_p, t))
        if corrector_order > 0:
            x = update(co, x, tau_fn(t), models, t_prev, noise, t, corrector=True)
            if pc_mode == "PECE":
                models[-1] = mf(x, t)
        else:
            x = x_p
        t_prev.append(t)

    for step in range(warm_end, steps + 1):
        po = min(predictor_order, steps - step + 1)
        co = min(corrector_order, steps - step + 2)
        t = float(tg[step])
        noise = draw(step)
        final_skip = few and step == steps  # few_steps takes no model call at the last point
        x_p = update(po, x, 0.0 if final_skip else tau_fn(t), models, t_prev, noise, t, corrector=False)
        if not final_skip:
            models.append(mf(x_p, t))
        if corrector_order > 0 and not final_skip:
            x = update(co, x, tau_fn(t), models, t_prev, noise, t, corrector=True)
            if pc_mode == "PECE" and step < steps:
                models[-1] = mf(x, t)
        else:
            x = x_p
        t_prev.append(t)
        del models[0]

    if not few:  # more_steps: denoise to zero
        x = (x - ns.std(t_0) * raw_eps(x, t_0)) / ns.alpha(t_0)
    return x
