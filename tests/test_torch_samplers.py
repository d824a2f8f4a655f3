"""The port's schedules and samplers against the JAX package on the CPU.

A fixed affine model (eps and the learned-variance channels affine in x and
t) at (2, 8, 8, 4), on the linear schedule and the respaced 'ddim10' and '25'
ones. Schedules and respacing are held exactly; sampler outputs to
1e-5 * max(1, max|ref|) in float32. The stochastic samplers are held with the
same draws on both sides: the JAX package's ``jax.random.normal`` is replaced
in the test by a queue of numpy-seeded arrays (inside a ``lax.scan`` it is
called once, so a DDPM or DDIM step draws the same array at every step), and
the port gets those arrays through its noise arguments; their zero-noise
limits are held too.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.diffusion import dpm_solver as jdpm
from instarevive_tpu.diffusion import one_step as jone_step
from instarevive_tpu.diffusion import gaussian as jG
from instarevive_tpu.diffusion import respace as jrespace
from instarevive_tpu.diffusion import sa_solver as jsa
from instarevive_tpu.diffusion import samplers as jsamplers
from instarevive_tpu.diffusion import schedules as jschedules
from instarevive_tpu_torch.diffusion import dpm_solver as tdpm
from instarevive_tpu_torch.diffusion import one_step as tone_step
from instarevive_tpu_torch.diffusion import gaussian as tG
from instarevive_tpu_torch.diffusion import respace as trespace
from instarevive_tpu_torch.diffusion import sa_solver as tsa
from instarevive_tpu_torch.diffusion import samplers as tsamplers
from instarevive_tpu_torch.diffusion import schedules as tschedules

SHAPE = (2, 8, 8, 4)
FIELDS = tschedules.DiffusionSchedule._fields


def close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def rand(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# the affine model: eps = a x + c t / 1000 (+ the learned-variance channels b x - 0.1)
A, C, B = 0.3, 0.2, 0.05


def jax_model(x, t):
    tt = t.astype(jnp.float32).reshape(-1, 1, 1, 1) / 1000.0
    return jnp.concatenate([A * x + C * tt, B * x - 0.1], axis=-1)


def torch_model(x, t):
    tt = t.float().reshape(-1, 1, 1, 1) / 1000.0
    return torch.cat([A * x + C * tt, B * x - 0.1], dim=-1)


def jax_eps(x, t):
    return jax_model(x, t)[..., :4]


def torch_eps(x, t):
    return torch_model(x, t)[..., :4]


def jax_sched(kind):
    return jschedules.make_schedule("linear", 1000) if kind == "linear" else jrespace.respaced_schedule(
        "linear", 1000, kind)


def torch_sched(kind):
    return tschedules.make_schedule("linear", 1000) if kind == "linear" else trespace.respaced_schedule(
        "linear", 1000, kind)


@pytest.fixture
def draws(monkeypatch):
    """Replace ``jax.random.normal`` by a queue of arrays; returns the list
    to fill. A call with the queue empty fails the test."""
    queue = []

    def normal(key, shape=(), dtype=jnp.float32):
        arr = queue.pop(0)
        assert tuple(arr.shape) == tuple(shape), (arr.shape, shape)
        return jnp.asarray(arr, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    return queue


# ------------------------------------------------------------------ schedules


@pytest.mark.parametrize("case", [("make", "linear"), ("make", "squaredcos_cap_v2"), ("make", "ldm_linear"),
                                  ("respace", "ddim10"), ("respace", "25"), ("respace", "10,5,3")])
def test_schedules_match_exactly(case):
    how, arg = case
    if how == "make":
        ref, out = jschedules.make_schedule(arg, 1000), tschedules.make_schedule(arg, 1000)
    else:
        assert trespace.space_timesteps(1000, arg) == jrespace.space_timesteps(1000, arg)
        ref, out = jrespace.respaced_schedule("linear", 1000, arg), trespace.respaced_schedule("linear", 1000, arg)
    assert FIELDS == jschedules.DiffusionSchedule._fields
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)


# ------------------------------------------------------------- the q/p math


@pytest.mark.parametrize("parameterization", ["eps", "x0", "v"])
@pytest.mark.parametrize("learned_range", [True, False])
def test_p_mean_variance(parameterization, learned_range):
    js, ts = jax_sched("25"), torch_sched("25")
    x = rand(0)
    out = rand(1, SHAPE[:3] + (8 if learned_range else 4,))
    t = np.array([3, 20])
    kw = dict(parameterization=parameterization, learned_range=learned_range, clip_denoised=parameterization == "v")
    ref = jG.p_mean_variance(js, jnp.asarray(out), jnp.asarray(x), jnp.asarray(t), **kw)
    got = tG.p_mean_variance(ts, torch.from_numpy(out), torch.from_numpy(x), torch.from_numpy(t), **kw)
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("case", [dict(learned_range=True), dict(learned_range=False, snr_switch_t=249),
                                  dict(learned_range=True, snr_switch_t=249, mask=True)])
def test_training_losses(case, draws):
    case = dict(case)
    js, ts = jax_sched("linear"), torch_sched("linear")
    x0, noise = rand(2), rand(3)
    t = np.array([100, 700])
    mask = (np.random.default_rng(4).random(SHAPE[:3]) < 0.6).astype(np.float32) if case.pop("mask", False) else None
    draws.append(noise)
    jm, tm = (jax_model, torch_model) if case["learned_range"] else (jax_eps, torch_eps)
    ref = jG.training_losses(js, jm, jnp.asarray(x0), jnp.asarray(t), jax.random.key(0),
                             mask=None if mask is None else jnp.asarray(mask), **case)
    got = tG.training_losses(ts, tm, torch.from_numpy(x0), torch.from_numpy(t), noise=torch.from_numpy(noise),
                             mask=None if mask is None else torch.from_numpy(mask), **case)
    for key in ("loss", "mse", "vb"):
        close(got[key], ref[key])


# ------------------------------------------------------------- DDPM and DDIM


@pytest.mark.parametrize("sched_kind", ["linear", "ddim10", "25"])
@pytest.mark.parametrize("z", ["shared", "zero"])
def test_ddpm(sched_kind, z, draws):
    js, ts = jax_sched(sched_kind), torch_sched(sched_kind)
    x_init = rand(5)
    step = rand(6) if z == "shared" else np.zeros(SHAPE, np.float32)
    draws.append(step)  # traced once: every step draws it
    clip = sched_kind == "25"
    ref = jG.ddpm_sample_loop(js, jax_model, SHAPE, jax.random.key(0), noise=jnp.asarray(x_init), clip_denoised=clip)
    got = tG.ddpm_sample_loop(ts, torch_model, SHAPE, noise=torch.from_numpy(x_init),
                              step_noise=torch.from_numpy(step).expand(ts.num_timesteps, *SHAPE), clip_denoised=clip)
    close(got, ref)


@pytest.mark.parametrize("sched_kind", ["linear", "ddim10", "25"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim(sched_kind, eta, draws):
    js, ts = jax_sched(sched_kind), torch_sched(sched_kind)
    x_init, step = rand(7), rand(8)
    draws.append(step)
    ref = jG.ddim_sample_loop(js, jax_model, SHAPE, jax.random.key(0), noise=jnp.asarray(x_init), eta=eta)
    got = tG.ddim_sample_loop(ts, torch_model, SHAPE, noise=torch.from_numpy(x_init), eta=eta,
                              step_noise=torch.from_numpy(step).expand(ts.num_timesteps, *SHAPE))
    close(got, ref)


def test_ddpm_draws_from_the_generator():
    """Without handed-in draws the loops draw from the generator: the same
    seed gives the same bits, another seed another sample."""
    ts = torch_sched("ddim10")
    run = [tG.ddpm_sample_loop(ts, torch_model, SHAPE, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])


# ------------------------------------------------------------------ DPM-Solver


@pytest.mark.parametrize("sched_kind", ["linear", "25"])
@pytest.mark.parametrize("steps", [1, 5, 20])
def test_dpm_solver_pp_2m(sched_kind, steps):
    js, ts = jax_sched(sched_kind), torch_sched(sched_kind)
    x = rand(9)
    clip = steps == 5
    ref = jdpm.dpm_solver_pp_2m(jax_eps, js, jnp.asarray(x), steps=steps, clip_denoised=clip)
    got = tdpm.dpm_solver_pp_2m(torch_eps, ts, torch.from_numpy(x), steps=steps, clip_denoised=clip)
    close(got, ref)


DPM_CASES = [
    dict(order=o, method=m, steps=6) for o in (1, 2, 3) for m in ("multistep", "singlestep", "singlestep_fixed")
] + [
    dict(order=3, method="singlestep", steps=7),
    dict(order=3, method="singlestep", steps=8, skip_type="logSNR"),
    dict(order=2, method="singlestep", steps=5, algorithm="dpmsolver"),
    dict(order=2, method="multistep", steps=6, algorithm="dpmsolver", skip_type="logSNR", solver_type="taylor"),
    dict(order=3, method="singlestep", steps=6, algorithm="dpmsolver", skip_type="time_quadratic",
         solver_type="taylor"),
    dict(order=3, method="singlestep_fixed", steps=6, solver_type="taylor"),
    dict(order=3, method="multistep", steps=6, algorithm="dpmsolver", lower_order_final=False),
    dict(order=2, method="singlestep", steps=6, solver_type="taylor", dynamic_thresholding=True,
         thresholding_max_val=0.5, denoise_to_zero=True),
    dict(order=3, method="multistep", steps=5, skip_type="logSNR", solver_type="taylor", denoise_to_zero=True),
]


@pytest.mark.parametrize("case", DPM_CASES, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_dpm_solver_sample(case):
    js, ts = jax_sched("linear"), torch_sched("linear")
    x = rand(10)
    ref = jdpm.dpm_solver_sample(jax_eps, js, jnp.asarray(x), **case)
    got = tdpm.dpm_solver_sample(torch_eps, ts, torch.from_numpy(x), **case)
    close(got, ref)


# ------------------------------------------------------------------ SA-Solver

SA_CASES = [
    dict(tau=0.0),
    dict(tau=1.0),
    dict(tau=1.0, mode="more_steps", pc_mode="PECE"),
    dict(tau=0.5, predictor_order=2, corrector_order=3, skip_type="logSNR"),
    dict(tau=1.0, predictor_order=1, corrector_order=2, algorithm="noise_prediction", skip_type="karras"),
    dict(tau=0.0, mode="more_steps", algorithm="noise_prediction", skip_order=2, dynamic_thresholding=False),
    dict(tau=0.7, predictor_order=2, corrector_order=0, dynamic_thresholding=True),
]


@pytest.mark.parametrize("case", SA_CASES, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_sa_solver_pc_sample(case):
    js, ts = jax_sched("linear"), torch_sched("linear")
    steps = 6
    x = rand(11)
    seq = np.stack([rand(100 + i) for i in range(steps + 1)])
    ref = jsa.sa_solver_pc_sample(jax_eps, js, jnp.asarray(x), steps=steps, noise_seq=jnp.asarray(seq), **case)
    got = tsa.sa_solver_pc_sample(torch_eps, ts, torch.from_numpy(x), steps=steps, noise_seq=torch.from_numpy(seq),
                                  **case)
    close(got, ref)


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_sa_solver_sample_and_stochastic(tau, draws):
    js, ts = jax_sched("linear"), torch_sched("linear")
    steps = 6
    x = rand(12)
    seq = np.stack([rand(200 + i) for i in range(steps)])
    if tau > 0:
        draws.extend(seq)
    ref = jsamplers.sa_solver_stochastic(jax_eps, js, jnp.asarray(x), jax.random.key(0), steps=steps, tau=tau)
    got = tsamplers.sa_solver_stochastic(torch_eps, ts, torch.from_numpy(x), steps=steps, tau=tau,
                                         noise_seq=torch.from_numpy(seq))
    close(got, ref)
    assert not draws
    ref = jsamplers.sa_solver_sample(jax_eps, js, jnp.asarray(x), steps=steps)
    close(tsamplers.sa_solver_sample(torch_eps, ts, torch.from_numpy(x), steps=steps), ref)


# --------------------------------------------------------------- PLMS and LCM


@pytest.mark.parametrize("sched_kind", ["linear", "ddim10", "25"])
def test_plms(sched_kind):
    js, ts = jax_sched(sched_kind), torch_sched(sched_kind)
    x = rand(13)
    ref = jsamplers.plms_sample_loop(js, jax_model, SHAPE, jax.random.key(0), noise=jnp.asarray(x))
    close(tsamplers.plms_sample_loop(ts, torch_model, SHAPE, noise=torch.from_numpy(x)), ref)


@pytest.mark.parametrize("case", [dict(num_steps=1), dict(num_steps=4), dict(num_steps=4, prediction_type="sample"),
                                  dict(num_steps=3, prediction_type="v_prediction", lcm_origin_steps=30)])
def test_lcm(case, draws):
    js, ts = jax_sched("linear"), torch_sched("linear")
    x = rand(14)
    seq = np.stack([rand(300 + i) for i in range(case["num_steps"])])
    draws.append(x)  # the JAX loop always draws its initial x
    ref = jsamplers.lcm_sample_loop(js, jax_model, SHAPE, jax.random.key(0), noise_seq=jnp.asarray(seq), **case)
    got = tsamplers.lcm_sample_loop(ts, torch_model, SHAPE, noise=torch.from_numpy(x), noise_seq=torch.from_numpy(seq),
                                    **case)
    close(got, ref)
    np.testing.assert_array_equal(tsamplers.lcm_timesteps(1000, 4, 50), jsamplers.lcm_timesteps(1000, 4, 50))


# ------------------------------------------------------------------------- EDM


def jax_denoise(x, sigma):
    return 0.8 * x / (1.0 + sigma) + 0.05 * sigma


def torch_denoise(x, sigma):
    return 0.8 * x / (1.0 + sigma) + 0.05 * sigma


def _queue_for_port(arrays):
    pending = [torch.from_numpy(a) for a in arrays]
    return lambda i: pending.pop(0)


EDM_CASES = [
    ("loop", dict()),
    ("loop", dict(S_churn=40.0, S_min=0.05, S_max=50.0)),
    ("ablation", dict()),
    ("ablation", dict(solver="euler", discretization="ve", schedule="ve")),
    ("ablation", dict(discretization="vp", schedule="vp", scaling="vp")),
    ("ablation", dict(discretization="iddpm", S_churn=30.0, alpha=0.8)),
    ("ablation", dict(discretization="ve", schedule="linear", S_churn=10.0, S_max=10.0)),
]


@pytest.mark.parametrize("case", EDM_CASES, ids=lambda c: c[0] + "-" + "-".join(f"{v}" for v in c[1].values()))
def test_edm(case, draws):
    which, kw = case
    steps = 8
    arrays = [rand(400 + i) for i in range(steps + 1)]
    draws.extend(arrays)
    jfn = jsamplers.edm_sample_loop if which == "loop" else jsamplers.edm_ablation_sample
    tfn = tsamplers.edm_sample_loop if which == "loop" else tsamplers.edm_ablation_sample
    ref = jfn(jax_denoise, SHAPE, jax.random.key(0), num_steps=steps, **kw)
    used = len(arrays) - len(draws)
    assert used >= 1 and (used > 1) == ("S_churn" in kw)
    got = tfn(torch_denoise, SHAPE, num_steps=steps, noise=torch.from_numpy(arrays[0]),
              churn_noise=_queue_for_port(arrays[1:used]), **kw)
    close(got, ref)


# ------------------------------------------------- guidance and the one step


def test_cfg_wrap_and_one_step():
    """Guidance around a caption-dependent affine model (eps mixed, the
    variance channels from the conditional rows), and the one-step x0."""
    js, ts = jax_sched("linear"), torch_sched("linear")
    x, y, null = rand(15), rand(16, (2, 1, 1, 4)), rand(17, (2, 1, 1, 4))

    def jm(x, t, y):
        return jax_model(x, t) + jnp.concatenate([y, 0.5 * y], axis=-1)

    def tm(x, t, y):
        return torch_model(x, t) + torch.cat([y, 0.5 * y], dim=-1)

    t = np.array([999, 400])
    ref = jone_step.cfg_wrap(jm, 4.5, {"y": jnp.asarray(null)}, split_channels=4)(jnp.asarray(x), jnp.asarray(t),
                                                                                    y=jnp.asarray(y))
    wrapped = tone_step.cfg_wrap(tm, 4.5, {"y": torch.from_numpy(null)}, split_channels=4)
    close(wrapped(torch.from_numpy(x), torch.from_numpy(t), y=torch.from_numpy(y)), ref)
    ref = jone_step.generate_sample_1step(jax_model, js, jnp.asarray(x), 400)
    close(tone_step.generate_sample_1step(torch_model, ts, torch.from_numpy(x), 400), ref)
