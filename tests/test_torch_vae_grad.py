"""A gradient through the frozen f32 VAE decode, the path of the Reflow
trainer's LPIPS term (``train/distill.reflow_loss``'s ``lpips_fn``), against
the JAX package on the CPU.

The same weights (numpy from a seed in the JAX trees, carried by
``convert/from_jax``) and the same inputs (numpy from a seed, or ``jax.random``
draws handed to the port) go through both packages:

* ``ops/norm_kernels.group_norm_silu``'s input gradient, with and without the
  SiLU, against flax's ``GroupNorm``: the CPU path (autograd through the plain
  version) and ``_GroupNormSilu``, the card's route (the kernels forward,
  autograd through the plain composition backward), whose forward takes the
  plain versions on CPU tensors;
* the decode's gradient in its latent input, a small VAE that keeps the mid
  block's ``AttnBlock`` (ch 32, (1, 2), one res block), against ``jax.grad``
  of the JAX decode, with either norm route;
* ``reflow_loss`` with ``lpips_fn(z, hq) = LPIPS(decode(z / 0.18215), hq).mean()``
  at the ``configs/cldm_tiny.yaml`` widths: the loss, both metrics and every
  UNet and ControlNet gradient against ``jax.value_and_grad`` of the same JAX
  composition, fed the same (t, z_T) draws. Bounds as
  ``tests/test_torch_cldm.py``: losses within 1e-5 of themselves, gradients
  within 1e-4 of their largest magnitude (f32; the sums run in another order).

The card runs the same composition through the kernels (K1 with its
log-sum-exp and K2 at head dim 512, K3, K5, the upsample), held there against
the plain versions (tests/test_torch_cuda.py, chip_smoke.py phase 20).
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import flax.linen as fnn
import jax
import jax.numpy as jnp

from instarevive_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from instarevive_tpu.models.unet import UNetBackbone as JaxUNet
from instarevive_tpu.models.vae import AutoencoderKL as JaxVAE
from instarevive_tpu.train import distill as jax_distill
from instarevive_tpu.train.cldm import ControlLDMTask as JaxTask
from instarevive_tpu.utils.metrics import LPIPS as JaxLPIPS
from instarevive_tpu_torch.convert.from_jax import lpips_params_to_torch, vae_params_to_torch
from instarevive_tpu_torch.diffusion.schedules import make_schedule
from instarevive_tpu_torch.models.unet import UNetBackbone
from instarevive_tpu_torch.models.vae import AutoencoderKL
from instarevive_tpu_torch.nn import layers
from instarevive_tpu_torch.ops import norm_kernels
from instarevive_tpu_torch.tools import iqa_checkpoints
from instarevive_tpu_torch.train import distill
from instarevive_tpu_torch.train.cldm import SCALE_FACTOR, ControlLDM, ControlLDMTask
from instarevive_tpu_torch.utils.metrics import LPIPS
from test_torch_cldm import GRAD_REL, LOSS_REL, TINY, _assert_grads, _export, _jax_cfg, _random_params, _rel

VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)  # mid block at 64 channels


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= GRAD_REL * top, (what, err, top)


def _norm_inputs(seed, n=2, h=6, w=5, c=64):
    """Activations with a per-channel offset and scale; gamma near 1, beta near 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)) * rng.uniform(0.5, 1.5, c) + rng.standard_normal(c)
    gamma, beta = 1.0 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)
    cot = rng.standard_normal((n, h, w, c))
    return [a.astype(np.float32) for a in (x, gamma, beta, cot)]


ROUTES = {"cpu_plain": norm_kernels.group_norm_silu, "card_function": norm_kernels._GroupNormSilu.apply}


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no_silu"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_group_norm_silu_input_gradient_matches_flax(route, silu):
    x, gamma, beta, cot = _norm_inputs(4)
    gn = fnn.GroupNorm(num_groups=32, epsilon=1e-6)

    def loss(x):
        y = gn.apply({"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}, x)
        return jnp.sum((jax.nn.silu(y) if silu else y) * cot)

    want = jax.grad(loss)(jnp.asarray(x))
    xt, g, b = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(gamma), torch.from_numpy(beta)
    out = ROUTES[route](xt, g, b, 32, 1e-6, silu)
    # either route's forward is the plain version's on CPU tensors, bit for bit
    torch.testing.assert_close(out, norm_kernels.group_norm_silu_plain(xt.detach(), g, b, silu=silu), rtol=0, atol=0)
    (got,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    _close(got, want, route)


@pytest.fixture(scope="module")
def vae():
    """The JAX VAE at ``VAE`` with seeded weights, and the port's with those
    weights, frozen."""
    jvae = JaxVAE(**VAE)
    params = _random_params(jvae, 21, np.zeros((1, 16, 16, 3), np.float32))
    tvae = AutoencoderKL(**VAE)
    sd = vae_params_to_torch(params, VAE["ch_mult"], VAE["num_res_blocks"])
    tvae.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return jvae, params, tvae.requires_grad_(False)


def _function_route(monkeypatch):
    """Every GroupNorm of the VAE through ``_GroupNormSilu`` when its input
    requires grad, as on the card."""
    def route(x, gamma, beta, groups=32, eps=1e-6, silu=True):
        if x.requires_grad:
            return norm_kernels._GroupNormSilu.apply(x, gamma, beta, groups, eps, silu)
        return norm_kernels.group_norm_silu(x, gamma, beta, groups, eps, silu)

    monkeypatch.setattr(layers, "group_norm_silu", route)


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_gradient_in_the_latent_matches_jax(vae, route, monkeypatch):
    jvae, params, tvae = vae
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cot = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    want = jax.jit(jax.grad(lambda z: jnp.sum(jvae.apply({"params": params}, z, method=jvae.decode) * cot)))(
        jnp.asarray(z))
    if route == "card_function":
        _function_route(monkeypatch)
    zt = torch.from_numpy(z).requires_grad_(True)
    (got,) = torch.autograd.grad((tvae.decode(zt) * torch.from_numpy(cot)).sum(), zt)
    _close(got, want, route)
    assert all(p.grad is None for p in tvae.parameters())


@pytest.fixture(scope="module")
def reflow_case(vae):
    """Both packages' Reflow step with the decode + LPIPS term on one set of
    weights, latents, context, HQ image and (t, z_T) draws; the JAX side's
    value and gradient."""
    jvae, vparams, tvae = vae
    rng = np.random.default_rng(0)
    b, hw = 2, 16  # 16^2 latents decode to 32^2 images, on which AlexNet's last features are 1 x 1
    z0, c_latent = (0.5 * rng.standard_normal((b, hw, hw, 4)).astype(np.float32) for _ in range(2))
    ctx = rng.standard_normal((b, 4, 32)).astype(np.float32)
    hq = rng.uniform(-1, 1, (b, 2 * hw, 2 * hw, 3)).astype(np.float32)
    ju, jc = JaxUNet(**_jax_cfg(TINY["unet"])), JaxUNet(**_jax_cfg(TINY["controlnet"]))
    params = {"unet": _random_params(ju, 1, z0, np.zeros(b, np.float32), ctx),
              "controlnet": _random_params(jc, 2, np.concatenate([z0, c_latent], -1), np.zeros(b, np.float32), ctx)}
    alex, lins = iqa_checkpoints.lpips(0)
    lparams = JaxLPIPS.alexnet_feature_params_from_torch(alex, lins)
    jlpips = JaxLPIPS(lparams)
    sched = jax_make_schedule("ldm_linear", 1000)
    jtask = JaxTask(ju, jc, None, None, sched)
    key = jax.random.key(8)
    t_rng, n_rng = jax.random.split(key)
    t = jax.random.randint(t_rng, (b,), 1, sched.num_timesteps)  # reflow_loss's draws from this key
    z_T = jax.random.normal(n_rng, z0.shape)
    cond = {"context": jnp.asarray(ctx), "c_latent": jnp.asarray(c_latent)}

    def jloss(p):
        def lpips_fn(z, img):
            return jlpips(jvae.apply({"params": vparams}, z / SCALE_FACTOR, method=jvae.decode), img).mean()

        return jax_distill.reflow_loss(sched, lambda p, z, t, context, c_latent: jtask.apply_model(
            p, z, t, context, c_latent), p, jnp.asarray(z0), key, cond, lpips_fn=lpips_fn, hq=jnp.asarray(hq))

    (jl, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = ControlLDM(UNetBackbone(**TINY["unet"]), UNetBackbone(**TINY["controlnet"]))
    model.load_state_dict({**_export(params["unet"], TINY["unet"], "unet."),
                           **_export(params["controlnet"], TINY["controlnet"], "controlnet.")}, strict=True)
    lpips = LPIPS()
    lpips.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in lpips_params_to_torch(lparams).items()})
    return dict(model=model, tvae=tvae, lpips=lpips.requires_grad_(False),
                task=ControlLDMTask(model.unet, model.controlnet, None, None, make_schedule("ldm_linear", 1000)),
                z0=z0, c_latent=c_latent, ctx=ctx, hq=hq, t=np.array(t), z_T=np.array(z_T),
                jloss=float(jl), jmetrics={k: float(v) for k, v in jmetrics.items()}, jgrads=jgrads)


def test_reflow_loss_with_the_lpips_term_and_its_gradients_match_jax(reflow_case):
    c = reflow_case
    task, tvae, lpips, model = c["task"], c["tvae"], c["lpips"], c["model"].requires_grad_(True)

    def lpips_fn(z, img):
        return lpips(tvae.decode(z / SCALE_FACTOR), img).mean()

    loss, metrics = distill.reflow_loss(
        task.sched, lambda z, t, context, c_latent: task.apply_model(z, t, context, c_latent),
        torch.from_numpy(c["z0"]), cond={"context": torch.from_numpy(c["ctx"]), "c_latent": torch.from_numpy(c["c_latent"])},
        lpips_fn=lpips_fn, hq=torch.from_numpy(c["hq"]), t=torch.from_numpy(c["t"]).long(), z_T=torch.from_numpy(c["z_T"]))
    assert set(metrics) == {"reflow_mse", "lpips"} == set(c["jmetrics"])
    assert _rel(loss.item(), c["jloss"]) <= LOSS_REL
    for name in metrics:
        assert _rel(metrics[name].item(), c["jmetrics"][name]) <= LOSS_REL, name
    assert c["jmetrics"]["lpips"] > 0 and 0.1 * c["jmetrics"]["lpips"] > 1e-3 * c["jloss"]  # the term counts
    _assert_grads(model, torch.autograd.grad(loss, list(model.parameters())), c["jgrads"])
    assert all(p.grad is None for p in (*tvae.parameters(), *lpips.parameters()))
