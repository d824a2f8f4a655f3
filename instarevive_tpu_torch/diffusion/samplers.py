"""More samplers (``instarevive_tpu/diffusion/samplers.py``): PLMS, LCM, EDM
(Karras Heun and the generalised ablation sampler), and SA-Solver's
deterministic and stochastic order-2 data-prediction forms.

Loops are Python loops over static step counts; schedules that do not depend
on the data are host numbers computed before the loop. Draws come from an
explicit ``torch.Generator`` or are handed in (``noise``, ``noise_seq``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from instarevive_tpu_torch.diffusion import gaussian as G
from instarevive_tpu_torch.diffusion.dpm_solver import _alpha_sigma_lambda, _linspace, dpm_solver_pp_2m, vp_grid
from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule, _on, extract, host_to


# ---------------------------------------------------------------------------
# PLMS
# ---------------------------------------------------------------------------


def plms_sample_loop(sched: DiffusionSchedule, model_fn: Callable, shape, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, learned_range: bool = True) -> torch.Tensor:
    """PLMS: the DDIM transfer with an Adams-Bashforth-extrapolated eps, after
    the reference's warm-up ladder (an RK2 first step, then orders 2 and 3)."""
    x = G._start(shape, generator, noise)
    n = sched.num_timesteps
    b = shape[0]
    tmap = _on(sched.timestep_map, x.device)

    def index(idx):
        return torch.full((b,), idx, dtype=torch.int64, device=x.device)

    def get_eps(x, idx):
        out = model_fn(x, tmap[index(idx)])
        return out[..., : x.shape[-1]] if learned_range else out

    def transfer(x, eps, idx):
        t = index(idx)
        abar = extract(sched.alphas_cumprod, t, x.ndim)
        abar_prev = extract(sched.alphas_cumprod_prev, t, x.ndim)
        x0 = (x - torch.sqrt(1 - abar) * eps) / torch.sqrt(abar)
        return torch.sqrt(abar_prev) * x0 + torch.sqrt(1 - abar_prev) * eps

    idx0 = n - 1
    e0 = get_eps(x, idx0)
    e1 = get_eps(transfer(x, e0, idx0), max(idx0 - 1, 0))
    x = transfer(x, (e0 + e1) / 2.0, idx0)
    old = [e0]  # the real eps history, newest last

    idx = n - 2
    for formula in (lambda e, o: (3 * e - o[-1]) / 2.0,
                    lambda e, o: (23 * e - 16 * o[-1] + 5 * o[-2]) / 12.0):
        if idx < 0:
            return x
        eps = get_eps(x, idx)
        x = transfer(x, formula(eps, old), idx)
        old.append(eps)
        idx -= 1

    h0, h1, h2 = old[-1], old[-2], old[-3]
    for i in range(idx, -1, -1):  # fourth-order Adams-Bashforth
        eps = get_eps(x, i)
        x = transfer(x, (55 * eps - 59 * h0 + 37 * h1 - 9 * h2) / 24.0, i)
        h0, h1, h2 = eps, h0, h1
    return x


# ---------------------------------------------------------------------------
# LCM
# ---------------------------------------------------------------------------


def lcm_boundary_scalings(t: torch.Tensor, sigma_data: float = 0.5, timestep_scaling: float = 10.0):
    """The consistency boundary conditions (c_skip, c_out)."""
    ts = t.float() * timestep_scaling
    return sigma_data**2 / (ts**2 + sigma_data**2), ts / torch.sqrt(ts**2 + sigma_data**2)


def lcm_timesteps(num_train_timesteps: int, num_steps: int, lcm_origin_steps: int) -> np.ndarray:
    """Every c-th original step (c = T // origin) of the LCM training ladder,
    subsampled by the skipping stride, descending."""
    c = num_train_timesteps // lcm_origin_steps
    origin = np.arange(1, lcm_origin_steps + 1) * c - 1
    skip = len(origin) // num_steps
    return origin[::-skip][:num_steps]


def lcm_sample_loop(sched: DiffusionSchedule, model_fn: Callable, shape, generator: Optional[torch.Generator] = None,
                    num_steps: int = 4, lcm_origin_steps: int = 50, learned_range: bool = True,
                    prediction_type: str = "epsilon", noise: Optional[torch.Tensor] = None,
                    noise_seq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LCM multi-step: a consistency x0 prediction under the boundary
    scalings, re-noised to the next ladder step (epsilon, sample or
    v_prediction). ``noise`` is the initial x, ``noise_seq`` (num_steps,
    *shape) the re-noising draws."""
    n = sched.num_timesteps
    ladder = lcm_timesteps(n, num_steps, lcm_origin_steps)
    x = G._start(shape, generator, noise)
    b = shape[0]
    tmap = _on(sched.timestep_map, x.device)

    for i, idx in enumerate(ladder):
        t = torch.full((b,), int(idx), dtype=torch.int64, device=x.device)
        out = model_fn(x, tmap[t])
        if learned_range:
            out = out[..., : x.shape[-1]]
        if prediction_type == "epsilon":
            x0 = G.predict_xstart_from_eps(sched, x, t, out)
        elif prediction_type == "sample":
            x0 = out
        elif prediction_type == "v_prediction":
            abar = extract(sched.alphas_cumprod, t, x.ndim)
            x0 = torch.sqrt(abar) * x - torch.sqrt(1.0 - abar) * out
        else:
            raise ValueError(prediction_type)
        c_skip, c_out = lcm_boundary_scalings(t.reshape((b,) + (1,) * (x.ndim - 1)))
        denoised = c_out * x0 + c_skip * x
        if num_steps > 1:
            if i == len(ladder) - 1:
                return denoised
            z = noise_seq[i] if noise_seq is not None else torch.randn(shape, generator=generator, device=x.device)
            t_prev = torch.full((b,), int(ladder[i + 1]), dtype=torch.int64, device=x.device)
            x = G.q_sample(sched, denoised, t_prev, z)
        else:
            x = denoised
    return x


# ---------------------------------------------------------------------------
# EDM (Karras)
# ---------------------------------------------------------------------------


def edm_sample_loop(denoise_fn: Callable, shape, generator: Optional[torch.Generator] = None, num_steps: int = 18,
                    sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0, S_churn: float = 0.0,
                    S_min: float = 0.0, S_max: float = float("inf"), S_noise: float = 1.0,
                    noise: Optional[torch.Tensor] = None,
                    churn_noise: Optional[Callable[[int], torch.Tensor]] = None) -> torch.Tensor:
    """Karras EDM Heun sampler (Algorithm 2) with optional churn: where
    S_churn > 0 and sigma lies in [S_min, S_max] the noise is raised by
    gamma = min(S_churn / num_steps, sqrt(2) - 1) before the step.
    ``denoise_fn(x, sigma)`` predicts x0, sigma a 0-dim float32 tensor.
    ``noise`` is the unit-variance initial draw, ``churn_noise(i)`` the churn
    draw of step i."""
    ts = np.asarray((sigma_max ** (1 / rho) + np.arange(num_steps) / (num_steps - 1)
                     * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho)
    ts = np.append(ts, 0.0)

    x = G._start(shape, generator, noise) * float(ts[0])
    for i in range(num_steps):
        t_cur, t_next = float(ts[i]), float(ts[i + 1])
        gamma = min(S_churn / num_steps, np.sqrt(2.0) - 1.0) if (S_churn > 0 and S_min <= t_cur <= S_max) else 0.0
        t_hat = t_cur + gamma * t_cur
        if gamma > 0:
            z = churn_noise(i) if churn_noise is not None else torch.randn(shape, generator=generator, device=x.device)
            x = x + float(np.sqrt(t_hat**2 - t_cur**2) * S_noise) * z
        d = (x - denoise_fn(x, _sigma(t_hat, x.device))) / t_hat
        x_next = x + (t_next - t_hat) * d
        if i < num_steps - 1:  # the second-order correction, but at the last step
            d2 = (x_next - denoise_fn(x_next, _sigma(t_next, x.device))) / t_next
            x_next = x + ((t_next - t_hat) * 0.5) * (d + d2)
        x = x_next
    return x


def _sigma(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def edm_ablation_sample(
    denoise_fn: Callable,
    shape,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 18,
    sigma_min: Optional[float] = None,
    sigma_max: Optional[float] = None,
    rho: float = 7.0,
    solver: str = "heun",
    discretization: str = "edm",
    schedule: str = "linear",
    scaling: str = "none",
    epsilon_s: float = 1e-3,
    C_1: float = 0.001,
    C_2: float = 0.008,
    M: int = 1000,
    alpha: float = 1.0,
    S_churn: float = 0.0,
    S_min: float = 0.0,
    S_max: float = float("inf"),
    S_noise: float = 1.0,
    net_sigma_min: float = 0.0,
    net_sigma_max: float = float("inf"),
    noise: Optional[torch.Tensor] = None,
    churn_noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> torch.Tensor:
    """The generalised EDM ablation sampler: VP / VE / iDDPM / EDM
    discretizations, vp / ve / linear sigma(t), vp / none scalings, Euler or
    Heun, and churn; every schedule quantity a host float64 number.
    ``denoise_fn(x_scaled, sigma)`` predicts x0."""
    if solver not in ("euler", "heun") or discretization not in ("vp", "ve", "iddpm", "edm"):
        raise ValueError(f"solver {solver!r}, discretization {discretization!r}")
    if schedule not in ("vp", "ve", "linear") or scaling not in ("vp", "none"):
        raise ValueError(f"schedule {schedule!r}, scaling {scaling!r}")

    def vp_sigma(bd, bm):
        return lambda t: np.sqrt(np.exp(0.5 * bd * t**2 + bm * t) - 1.0)

    def vp_sigma_inv(bd, bm):
        return lambda sg: (np.sqrt(bm**2 + 2 * bd * np.log(sg**2 + 1)) - bm) / bd

    if sigma_min is None:
        sigma_min = {"vp": float(vp_sigma(19.1, 0.1)(epsilon_s)), "ve": 0.02, "iddpm": 0.002,
                     "edm": 0.002}[discretization]
    if sigma_max is None:
        sigma_max = {"vp": float(vp_sigma(19.1, 0.1)(1.0)), "ve": 100.0, "iddpm": 81.0, "edm": 80.0}[discretization]
    sigma_min = max(sigma_min, net_sigma_min)  # the network's supported range
    sigma_max = min(sigma_max, net_sigma_max)

    vp_beta_d = 2 * (np.log(sigma_min**2 + 1) / epsilon_s - np.log(sigma_max**2 + 1)) / (epsilon_s - 1)
    vp_beta_min = np.log(sigma_max**2 + 1) - 0.5 * vp_beta_d

    idx = np.arange(num_steps, dtype=np.float64)
    if discretization == "vp":
        orig = 1 + idx / (num_steps - 1) * (epsilon_s - 1)
        sigma_steps = vp_sigma(vp_beta_d, vp_beta_min)(orig)
    elif discretization == "ve":
        orig = (sigma_max**2) * ((sigma_min**2 / sigma_max**2) ** (idx / (num_steps - 1)))
        sigma_steps = np.sqrt(orig)
    elif discretization == "iddpm":
        u = np.zeros(M + 1)

        def abar(j):
            return np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2

        for j in range(M, 0, -1):
            u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(abar(j - 1) / abar(j), C_1) - 1)
        uf = u[(u >= sigma_min) & (u <= sigma_max)]
        sigma_steps = uf[np.round((len(uf) - 1) / (num_steps - 1) * idx).astype(int)]
    else:
        sigma_steps = (sigma_max ** (1 / rho) + idx / (num_steps - 1)
                       * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho

    if schedule == "vp":
        sigma_f = vp_sigma(vp_beta_d, vp_beta_min)

        def sigma_deriv(t):
            return 0.5 * (vp_beta_min + vp_beta_d * t) * (sigma_f(t) + 1.0 / sigma_f(t))

        sigma_inv = vp_sigma_inv(vp_beta_d, vp_beta_min)
    elif schedule == "ve":
        def sigma_f(t):
            return np.sqrt(t)

        def sigma_deriv(t):
            return 0.5 / np.sqrt(t)

        def sigma_inv(sg):
            return sg**2
    else:
        def sigma_f(t):
            return t

        def sigma_deriv(t):
            return 1.0

        def sigma_inv(sg):
            return sg

    if scaling == "vp":
        def s_f(t):
            return 1.0 / np.sqrt(1.0 + sigma_f(t) ** 2)

        def s_deriv(t):
            return -sigma_f(t) * sigma_deriv(t) * (s_f(t) ** 3)
    else:
        def s_f(t):
            return 1.0

        def s_deriv(t):
            return 0.0

    t_steps = np.append(sigma_inv(sigma_steps), 0.0)

    t0 = float(t_steps[0])
    x = G._start(shape, generator, noise) * float(sigma_f(t0) * s_f(t0))
    for i in range(num_steps):
        t_cur, t_next = float(t_steps[i]), float(t_steps[i + 1])
        sc = sigma_f(t_cur)
        gamma = min(S_churn / num_steps, np.sqrt(2.0) - 1.0) if (S_churn > 0 and S_min <= sc <= S_max) else 0.0
        t_hat = float(sigma_inv(sc + gamma * sc))
        sh, ssh = float(sigma_f(t_hat)), float(s_f(t_hat))
        x_hat = float(ssh / s_f(t_cur)) * x
        if gamma > 0:
            z = churn_noise(i) if churn_noise is not None else torch.randn(shape, generator=generator, device=x.device)
            x_hat = x_hat + float(np.sqrt(max(sh**2 - sc**2, 0.0)) * ssh * S_noise) * z
        h = t_next - t_hat
        den = denoise_fn(x_hat / ssh, _sigma(sh, x.device))
        d_cur = float(sigma_deriv(t_hat) / sh + s_deriv(t_hat) / ssh) * x_hat - float(sigma_deriv(t_hat) * ssh / sh) * den
        if solver == "euler" or i == num_steps - 1:
            x = x_hat + h * d_cur
        else:
            t_p = t_hat + alpha * h
            x_p = x_hat + (alpha * h) * d_cur
            sp, ssp = float(sigma_f(t_p)), float(s_f(t_p))
            den2 = denoise_fn(x_p / ssp, _sigma(sp, x.device))
            d_p = float(sigma_deriv(t_p) / sp + s_deriv(t_p) / ssp) * x_p - float(sigma_deriv(t_p) * ssp / sp) * den2
            x = x_hat + h * (float(1 - 1 / (2 * alpha)) * d_cur + float(1 / (2 * alpha)) * d_p)
    return x


# ---------------------------------------------------------------------------
# SA-Solver, order-2 data-prediction multistep
# ---------------------------------------------------------------------------


def sa_solver_sample(model_fn: Callable, sched: DiffusionSchedule, x: torch.Tensor, steps: int = 25) -> torch.Tensor:
    """The deterministic SA-Solver predictor (tau = 0): the data-prediction
    multistep ODE solver, DPM-Solver++(2M)."""
    return dpm_solver_pp_2m(model_fn, sched, x, steps=steps)


def sa_solver_stochastic(model_fn: Callable, sched: DiffusionSchedule, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None, steps: int = 25, tau: float = 1.0,
                         t_start: float = 1.0, t_end: Optional[float] = None,
                         noise_seq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stochastic Adams solver, order-2 data prediction with tau-scaled
    noise; tau = 0 is the deterministic exponential-integrator multistep.

    With h = lambda_{i+1} - lambda_i and A = 1 + tau^2, a step is
      x_{i+1} = (s_{i+1}/s_i) e^{-tau^2 h} x_i + a_{i+1} (1 - e^{-Ah}) x0_i
                + a_{i+1} (h - (1 - e^{-Ah}) / A) (x0_i - x0_{i-1}) / h_{i-1}
                + s_{i+1} sqrt(1 - e^{-2 tau^2 h}) xi,
    the slope term from the second step on. ``noise_seq[i]`` (steps,
    *x.shape) is xi of step i when given. The grid is float32 on the host, as
    in ``dpm_solver_pp_2m``, moved to the device in one copy.
    """
    grid = vp_grid(sched)
    t_end = t_end if t_end is not None else 1.0 / grid.total_n
    ts = _linspace(t_start, t_end, steps + 1)
    alpha, sigma, lam = _alpha_sigma_lambda(grid, ts)
    t_in = (ts - 1.0 / grid.total_n) * 1000.0
    s2 = 1.0 + tau * tau
    h = lam[1:] - lam[:-1]
    e = torch.exp(-s2 * h)
    decay = torch.exp(-tau * tau * h)
    noise_coef = sigma[1:] * torch.sqrt(torch.clamp(1.0 - decay * decay, min=0.0))
    h_prev = torch.cat([torch.ones(1), h[:-1]])  # the first step has no slope term
    table = host_to(torch.stack([t_in[:-1], alpha[:-1], sigma[:-1], (sigma[1:] / sigma[:-1]) * decay,
                                 alpha[1:] * (1.0 - e), alpha[1:] * (h - (1.0 - e) / s2), h_prev, noise_coef]),
                    x.device)
    b = x.shape[0]

    x0_prev = None
    for i in range(steps):
        eps = model_fn(x, table[0, i].expand(b))
        x0_cur = (x - table[2, i] * eps) / table[1, i]
        x_new = table[3, i] * x + table[4, i] * x0_cur
        if i > 0:
            x_new = x_new + table[5, i] * ((x0_cur - x0_prev) / table[6, i])
        if tau > 0:
            z = noise_seq[i] if noise_seq is not None else torch.randn(x.shape, generator=generator, device=x.device)
            x_new = x_new + table[7, i] * z
        x, x0_prev = x_new, x0_cur
    return x
