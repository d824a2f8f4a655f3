"""Training objectives (``instarevive_tpu/train/distill.py``): SwinIR stage-1,
Reflow velocity matching, and the DMD distillation step (distribution
matching + paired regression): a one-step generator trained with (a)
paired-noise regression and (b) a distribution-matching gradient from a
frozen "real" teacher score against a trainable "fake" score model that
itself trains by denoising the generator's outputs.

Model functions are ``(z, t, **cond) -> eps`` closures over ``nn.Module``s
(the JAX package's take the parameter tree as their first argument). The
whole distribution-matching target is constant in the JAX package (it sits
under ``stop_gradient``), so here the teacher and the fake score inside the
generator loss run under ``torch.no_grad`` on a detached ``x_t``.

Randomness: every draw comes from an explicit ``torch.Generator`` through
``draw_timesteps`` and ``draw_noise``; each loss also accepts the drawn
tensors, so that a test can hand this package and the JAX package the same
timesteps and noise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from instarevive_tpu_torch.diffusion import gaussian as G
from instarevive_tpu_torch.diffusion.one_step import eps_to_x0
from instarevive_tpu_torch.diffusion.schedules import DiffusionSchedule
from instarevive_tpu_torch.train.state import TrainState

ModelFn = Callable[..., torch.Tensor]


def draw_timesteps(generator: torch.Generator, b: int, low: int, high: int, device) -> torch.Tensor:
    """(b,) int64 timesteps uniform in [low, high)."""
    return torch.randint(low, high, (b,), generator=generator, device=device)


def draw_noise(generator: torch.Generator, shape, device, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def draw_dmd(generator: torch.Generator, shape, num_timesteps: int, device, min_dm_t: int = 20,
             max_dm_t: int = 979) -> Dict[str, torch.Tensor]:
    """The draws of one DMD step on latents of ``shape``, in the order the
    step makes them (``make_dmd_train_step``'s ``draws``)."""
    b = shape[0]
    return {"t_dm": draw_timesteps(generator, b, min_dm_t, max_dm_t, device),
            "noise_dm": draw_noise(generator, shape, device),
            "t_fake": draw_timesteps(generator, b, 0, num_timesteps, device),
            "noise_fake": draw_noise(generator, shape, device)}


# ---------------------------------------------------------------------------
# SwinIR stage-1


def swinir_loss(model: Callable, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.mean((model(batch["lq"]) - batch["hq"]) ** 2)


# ---------------------------------------------------------------------------
# Reflow (velocity matching)


def reflow_loss(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    z0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cond: Optional[Dict[str, Any]] = None,
    lpips_fn: Optional[Callable] = None,
    lpips_weight: float = 0.1,
    hq: Optional[torch.Tensor] = None,
    *,
    t: Optional[torch.Tensor] = None,
    z_T: Optional[torch.Tensor] = None,
):
    """v-prediction on the straight path z_t = t_hat z_T + (1 - t_hat) z0,
    t ~ U[1, T), target z0 - z_T."""
    cond = cond or {}
    b, T = z0.shape[0], sched.num_timesteps
    if t is None:
        t = draw_timesteps(generator, b, 1, T, z0.device)
    if z_T is None:
        z_T = draw_noise(generator, z0.shape, z0.device)
    t_hat = (t.float() / T).reshape(b, 1, 1, 1)
    z_t = t_hat * z_T + (1.0 - t_hat) * z0
    v = model_fn(z_t, t, **cond)
    loss = torch.mean((v - (z0 - z_T)) ** 2)
    metrics = {"reflow_mse": loss.detach()}
    if lpips_fn is not None and hq is not None:
        x_refine = lpips_fn(z_T + v, hq)
        loss = loss + lpips_weight * x_refine
        metrics["lpips"] = x_refine.detach()
    return loss, metrics


def reflow_sample_1step(sched: DiffusionSchedule, model_fn: ModelFn, z_T: torch.Tensor, cond: Dict[str, Any]):
    """Single Euler step z_T + v at t = T - 1."""
    t = torch.full((z_T.shape[0],), sched.num_timesteps - 1, dtype=torch.int64, device=z_T.device)
    return z_T + model_fn(z_T, t, **cond)


# ---------------------------------------------------------------------------
# DMD distillation


def make_cfg_real_fn(raw_fn: ModelFn, y_null: torch.Tensor, cfg_scale: float) -> ModelFn:
    """Fold classifier-free guidance into the frozen teacher ("real score"):
    eps = eps_uncond + s * (eps_cond - eps_uncond), the null-prompt embedding
    as the unconditional branch, the pair run as one batched 2B call.

    raw_fn: (z, t, **cond) -> eps with the sigma split already applied.
    y_null: (L, C) or (1, L, C) null-prompt embedding."""
    if cfg_scale == 1.0:
        return raw_fn
    if y_null.ndim == 3:
        y_null = y_null[0]

    def real_fn(z, t, **cond):
        y = cond["y"]
        L = y.shape[1]
        yn = y_null.to(device=y.device, dtype=y.dtype)
        if yn.shape[0] < L:  # fit the null embed to the cond token length
            yn = torch.nn.functional.pad(yn, (0, 0, 0, L - yn.shape[0]))
        elif yn.shape[0] > L:
            yn = yn[:L]
        cond2 = dict(cond)
        cond2["y"] = torch.cat([y, yn[None].expand_as(y)], dim=0)
        if cond2.get("mask") is not None:
            cond2["mask"] = torch.cat([cond2["mask"], cond2["mask"]], dim=0)
        eps2 = raw_fn(torch.cat([z, z], dim=0), torch.cat([t, t], dim=0), **cond2)
        e_cond, e_uncond = eps2.chunk(2, dim=0)
        return e_uncond + cfg_scale * (e_cond - e_uncond)

    return real_fn


def dmd_weighting(sched: DiffusionSchedule, x0_pred, x0_real, t):
    """Per-sample normalizer 1 / mean|x0_pred - x0_real|, so that the
    distribution-matching gradient has unit scale."""
    diff = (x0_pred - x0_real).abs().mean(dim=tuple(range(1, x0_pred.ndim)), keepdim=True)
    return 1.0 / diff.clamp_min(1e-5)


def dmd_generator_loss(
    sched: DiffusionSchedule,
    gen_fn: ModelFn,    # the generator, with grad
    real_fn: ModelFn,   # frozen teacher eps with CFG applied
    fake_fn: ModelFn,   # the fake score, no grad here
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    maxt: int = 400,
    min_dm_t: int = 20,
    max_dm_t: int = 979,
    use_dm: bool = True,
    use_regression: bool = True,
    regression_weight: float = 0.25,
    cond: Optional[Dict[str, Any]] = None,
    t_dm: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Generator update: regression on paired (noise, latent) + DM gradient.
    batch: 'noise' (B,H,W,4) paired init noise, 'latent' (B,H,W,4) target VAE
    latent. ``t_dm`` (B,) and ``noise`` are drawn from ``generator`` unless
    given. Returns (loss, (metrics, x0_pred detached))."""
    cond = cond or {}
    z = batch["noise"]
    b = z.shape[0]
    t_gen = torch.full((b,), maxt, dtype=torch.int64, device=z.device)

    # one-step generation from the paired noise
    x0_pred = eps_to_x0(sched, gen_fn(z, t_gen, **cond), z, t_gen)

    metrics: Dict[str, torch.Tensor] = {}
    loss = x0_pred.new_zeros(())
    if use_regression:
        reg = torch.mean((x0_pred - batch["latent"]) ** 2)
        loss = loss + regression_weight * reg
        metrics["regression"] = reg.detach()

    if use_dm:
        if t_dm is None:
            t_dm = draw_timesteps(generator, b, min_dm_t, max_dm_t, z.device)
        if noise is None:
            noise = draw_noise(generator, x0_pred.shape, z.device)
        with torch.no_grad():
            x0 = x0_pred.detach()
            x_t = G.q_sample(sched, x0, t_dm, noise)
            x0_real = G.predict_xstart_from_eps(sched, x_t, t_dm, real_fn(x_t, t_dm, **cond).float())
            x0_fake = G.predict_xstart_from_eps(sched, x_t, t_dm, fake_fn(x_t, t_dm, **cond).float())
            w = dmd_weighting(sched, x0, x0_real, t_dm)
            # the gradient of 0.5 |x0_pred - target|^2 in x0_pred is w (x0_fake - x0_real)
            target = x0 - w * (x0_fake - x0_real)
        dm = 0.5 * torch.mean((x0_pred - target) ** 2)
        loss = loss + dm
        metrics["dm"] = dm.detach()
    metrics["loss"] = loss.detach()
    return loss, (metrics, x0_pred.detach())


def dmd_fake_score_loss(
    sched: DiffusionSchedule,
    fake_fn: ModelFn,
    x0_gen: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cond: Optional[Dict[str, Any]] = None,
    *,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fake-score update: the standard denoising loss on generator samples."""
    cond = cond or {}
    if t is None:
        t = draw_timesteps(generator, x0_gen.shape[0], 0, sched.num_timesteps, x0_gen.device)
    if noise is None:
        noise = draw_noise(generator, x0_gen.shape, x0_gen.device)
    eps = fake_fn(G.q_sample(sched, x0_gen, t, noise), t, **cond)
    return torch.mean((eps.float() - noise) ** 2)


def make_dmd_train_step(
    sched: DiffusionSchedule,
    gen_fn: ModelFn,
    real_fn: ModelFn,
    fake_fn: ModelFn,
    *,
    maxt: int = 400,
    regression_weight: float = 0.25,
    on_phase: Optional[Callable[[str], None]] = None,
):
    """Returns train_step(gen_state, fake_state, batch, generator, cond=None,
    draws=None) -> metrics, which updates both states in place.

    ``gen_fn`` must run ``gen_state``'s module and ``fake_fn``
    ``fake_state``'s. Teacher CFG must already be folded into ``real_fn``
    (``make_cfg_real_fn``). ``draws`` may hand in 't_dm', 'noise_dm', 't_fake'
    and 'noise_fake'; what it lacks is drawn from ``generator`` in that order.
    ``on_phase`` is called with 'generator_update', 'generator_optimizer',
    'fake_update', 'fake_optimizer' and 'end' as each begins (a hook for timing)."""
    mark = on_phase or (lambda name: None)

    def train_step(gen_state: TrainState, fake_state: TrainState, batch, generator=None, cond=None, draws=None,
                   keep_grads: Optional[dict] = None):
        draws = draws or {}
        mark("generator_update")
        gl, (metrics, x0_gen) = dmd_generator_loss(
            sched, gen_fn, real_fn, fake_fn, batch, generator, maxt=maxt, regression_weight=regression_weight,
            cond=cond, t_dm=draws.get("t_dm"), noise=draws.get("noise_dm"),
        )
        ggrads = gen_state.gradients(gl)
        del gl
        mark("generator_optimizer")
        gen_state.apply_gradients(ggrads)

        mark("fake_update")
        fl = dmd_fake_score_loss(sched, fake_fn, x0_gen, generator, cond,
                                 t=draws.get("t_fake"), noise=draws.get("noise_fake"))
        fgrads = fake_state.gradients(fl)
        mark("fake_optimizer")
        fake_state.apply_gradients(fgrads)
        mark("end")

        if keep_grads is not None:  # for tests and the card-against-CPU check
            keep_grads.update(generator=ggrads, fake=fgrads)
        metrics = dict(metrics)
        metrics["fake_score"] = fl.detach()
        return metrics

    return train_step
