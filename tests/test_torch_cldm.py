"""The port's LDM/ControlNet training (instarevive_tpu_torch/train/cldm.py and
``--task cldm|reflow`` of the launcher) against the JAX package on the CPU, at
the ``configs/cldm_tiny.yaml`` widths.

The same weights (numpy from a seed in the JAX tree, carried by
``convert/from_jax``), the same latents (handed to both ``get_input``s) and
the same draws (made with ``jax.random`` from the key exactly as
``instarevive_tpu/train/cldm.py`` splits it, and handed to the port) go
through ``eps_loss``, ``reflow_loss`` and ``dist_loss`` of both packages:
losses within 1e-5 of themselves, every gradient within 1e-4 of its largest
magnitude (f32; the sums run in another order; see ``_assert_grads``). One optimizer step through
both packages' ``nan_guard``: the trained leaves agree; the port's frozen
leaves keep their bits while the JAX package's ``optax.masked`` moves each by
its gradient (ROADMAP §C). The launcher trains, resumes and takes
``--t_sampler`` and ``--context_npz``."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from instarevive_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from instarevive_tpu.models.unet import UNetBackbone as JaxUNet
from instarevive_tpu.train import lora as jax_lora
from instarevive_tpu.train import optim as jax_optim
from instarevive_tpu.train.cldm import ControlLDMTask as JaxTask
from instarevive_tpu.train.state import TrainState as JaxTrainState
from instarevive_tpu.utils.debug import nan_guard as jax_nan_guard
from instarevive_tpu_torch.convert.from_jax import unet_kw, unet_params_to_torch
from instarevive_tpu_torch.diffusion.schedules import make_schedule
from instarevive_tpu_torch.models.unet import UNetBackbone
from instarevive_tpu_torch.train import optim
from instarevive_tpu_torch.train.cldm import ControlLDM, ControlLDMTask
from instarevive_tpu_torch.train.state import TrainState
from instarevive_tpu_torch.utils.debug import nan_guard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PATH = os.path.join(REPO, "configs", "cldm_tiny.yaml")
TINY = yaml.safe_load(open(TINY_PATH))
LOSS_REL, GRAD_REL = 1e-5, 1e-4


def _jax_cfg(section):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in section.items()}


def _random_params(model, seed, *args):
    """Numpy weights in the JAX tree (shapes by ``jax.eval_shape``), every leaf non-zero."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        out = x / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel" else (1.0 + 0.1 * x if name == "scale" else 0.1 * x)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _export(params, section, prefix=""):
    return {prefix + k: torch.from_numpy(np.array(v)) for k, v in unet_params_to_torch(params, **unet_kw(section)).items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _unet_leaf_trainable(path):
    """``train.py``'s mask: the ControlNet, and the UNet's out_*/up_* leaves."""
    top = path[0].key
    return top == "controlnet" or (top == "unet" and path[1].key.startswith(("out_", "up_")))


@pytest.fixture(scope="module")
def case():
    """Both packages' task on one set of weights, latents and context."""
    rng = np.random.default_rng(0)
    b, hw = 2, 8
    z0, c_latent = 0.5 * rng.standard_normal((b, hw, hw, 4)).astype(np.float32), \
        0.5 * rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, 4, 32)).astype(np.float32)
    ju, jc = JaxUNet(**_jax_cfg(TINY["unet"])), JaxUNet(**_jax_cfg(TINY["controlnet"]))
    params = {"unet": _random_params(ju, 1, z0, np.zeros(b, np.float32), ctx),
              "controlnet": _random_params(jc, 2, np.concatenate([z0, c_latent], -1), np.zeros(b, np.float32), ctx)}
    jtask = JaxTask(ju, jc, None, None, jax_make_schedule("ldm_linear", 1000))
    jtask.get_input = lambda frozen, batch: (jnp.asarray(z0), jnp.asarray(c_latent))  # the latents, handed in
    model = ControlLDM(UNetBackbone(**TINY["unet"]), UNetBackbone(**TINY["controlnet"]))
    model.load_state_dict({**_export(params["unet"], TINY["unet"], "unet."),
                           **_export(params["controlnet"], TINY["controlnet"], "controlnet.")}, strict=True)
    task = ControlLDMTask(model.unet, model.controlnet, None, None, make_schedule("ldm_linear", 1000))
    return dict(params=params, jtask=jtask, model=model, task=task, jbatch={"context": jnp.asarray(ctx)},
                batch={"context": torch.from_numpy(ctx)}, latents=(torch.from_numpy(z0), torch.from_numpy(c_latent)))


def _flat_grads(tree):
    """A JAX gradient tree {'unet', 'controlnet'} under the port's names."""
    return {**_export(tree["unet"], TINY["unet"], "unet."), **_export(tree["controlnet"], TINY["controlnet"], "controlnet.")}


def _assert_grads(model, got, want_tree, names=None):
    """Each gradient within GRAD_REL of its largest magnitude, or of a
    hundredth of the largest over the model where that is more: a conv bias
    in front of a GroupNorm of one channel a group has an analytic gradient
    of 0, and both packages give it rounding noise (1e-9 here)."""
    want = _flat_grads(want_tree)
    names = names or [n for n, _ in model.named_parameters()]
    top = max(w.abs().max().item() for w in want.values())
    for name, g in zip(names, got):
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * max(np.abs(w).max(), 1e-2 * top), name


@pytest.fixture(scope="module")
def eps_case(case):
    """One eps-loss value and gradient of each package at handed-in t,
    weights and noise."""
    key = jax.random.key(7)
    _, n_rng = jax.random.split(key)
    t, w = jnp.asarray([5, 900]), jnp.asarray([0.7, 1.3])
    noise = jax.random.normal(n_rng, case["latents"][0].shape)
    jtask = case["jtask"]
    (jloss, aux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask.eps_loss(p, None, case["jbatch"], key, t=t, loss_weights=w), has_aux=True))(case["params"])
    model = case["model"].requires_grad_(True)
    loss, metrics = case["task"].eps_loss(case["batch"], t=torch.from_numpy(np.asarray(t)), loss_weights=torch.from_numpy(
        np.asarray(w)), noise=torch.from_numpy(np.asarray(noise)), latents=case["latents"])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return dict(jloss=jloss, jaux=aux, jgrads=jgrads, loss=loss, metrics=metrics, grads=grads)


def test_eps_loss_and_its_gradients_match_jax(case, eps_case):
    assert _rel(eps_case["loss"].item(), float(eps_case["jloss"])) <= LOSS_REL
    np.testing.assert_allclose(eps_case["metrics"]["per_sample_loss"].numpy(), np.asarray(eps_case["jaux"]["per_sample_loss"]),
                               rtol=LOSS_REL)
    _assert_grads(case["model"], eps_case["grads"], eps_case["jgrads"])


def test_reflow_loss_and_its_gradients_match_jax(case):
    key = jax.random.key(8)
    t_rng, n_rng = jax.random.split(key)
    z0 = case["latents"][0]
    t = jax.random.randint(t_rng, (z0.shape[0],), 1, 1000)
    z_T = jax.random.normal(n_rng, z0.shape)
    jtask = case["jtask"]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask.reflow_loss(p, None, case["jbatch"], key), has_aux=True))(case["params"])
    model = case["model"].requires_grad_(True)
    loss, metrics = case["task"].reflow_loss(case["batch"], t=torch.from_numpy(np.asarray(t)).long(),
                                             z_T=torch.from_numpy(np.asarray(z_T)), latents=case["latents"])
    assert _rel(loss.item(), float(jloss)) <= LOSS_REL and "reflow_mse" in metrics
    _assert_grads(model, torch.autograd.grad(loss, list(model.parameters())), jgrads)


def test_dist_loss_and_its_lora_gradients_match_jax(case):
    """LoRA adapters from the JAX package's ``init_lora`` (``b`` made
    non-zero) carried to the port's layout; the loss and the gradient of
    every adapter agree."""
    key = jax.random.key(9)
    pu = case["params"]["unet"]
    jl = jax_lora.init_lora(jax.random.key(3), jax.tree_util.tree_map(jnp.asarray, pu), rank=4)
    jl = jax.tree_util.tree_map(lambda x: x + 0.02 * jax.random.normal(jax.random.key(4), x.shape), jl)
    z_T = jax.random.normal(key, case["latents"][0].shape)
    jtask = case["jtask"]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda lo: jtask.dist_loss(lo, case["params"], None, case["jbatch"], key), has_aux=True))(jl)

    # each JAX adapter's module, found by its base kernel among the exported weights
    base = {n: p.detach() for n, p in case["model"].unet.named_parameters()}
    paths = [p[:-2] for p in _paths(jl) if p.endswith("/a")]
    lora, grad_want = {}, {}
    for path in paths:
        kernel = np.asarray(jax_lora._get(pu, path + "/kernel"))
        (module,) = [n[: -len(".weight")] for n, w in base.items()
                     if n.endswith(".weight") and w.ndim == 2 and np.array_equal(w.numpy(), kernel.T)]
        ad = jax_lora._get(jl, path)
        lora[module] = {"down": torch.from_numpy(np.array(ad["a"]).T.copy()).requires_grad_(True),
                        "up": torch.from_numpy(np.array(ad["b"]).T.copy()).requires_grad_(True)}
        g = jax_lora._get(jgrads, path)
        grad_want[module] = (np.asarray(g["a"]).T, np.asarray(g["b"]).T)
    loss, metrics = case["task"].dist_loss(lora, case["batch"], z_T=torch.from_numpy(np.asarray(z_T)),
                                           latents=case["latents"])
    assert _rel(loss.item(), float(jloss)) <= LOSS_REL and "dist_mse" in metrics
    flat = [t for ad in lora.values() for t in (ad["down"], ad["up"])]
    grads = dict(zip([(m, k) for m in lora for k in ("down", "up")], torch.autograd.grad(loss, flat)))
    top = max(np.abs(g).max() for pair in grad_want.values() for g in pair)
    for module, want in grad_want.items():  # as _assert_grads: of its largest magnitude, or of top / 100
        for key, w in zip(("down", "up"), want):
            err = np.abs(grads[(module, key)].numpy() - w).max()
            assert err <= GRAD_REL * max(np.abs(w).max(), 1e-2 * top), (module, key)


def _paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p


def test_one_step_trains_the_same_leaves_and_keeps_the_frozen_ones(case, eps_case):
    """One AdamW step with clipping through both packages' ``nan_guard`` on
    the same gradient: the ControlNet and the UNet's decoder agree; the
    port's frozen leaves (the UNet's encoder, middle and time embedding)
    keep their bits; the JAX package's move by exactly +1 x their gradient.
    The JAX side runs ``train.py``'s ``optax.masked`` over two leaves, every
    trained and every frozen parameter each flattened into one: the global
    clipping norm is over the trained ones either way and AdamW is
    elementwise, so this is the per-leaf update, without a compile per leaf."""
    old = {n: p.detach() for n, p in case["model"].named_parameters()}
    jgrad = _flat_grads(eps_case["jgrads"])
    trained = [n for n in old if n.startswith(("controlnet.", "unet.output_blocks.", "unet.out."))]
    frozen = [n for n in old if n not in trained]

    def flat(tree, names):
        return jnp.concatenate([jnp.asarray(tree[n].numpy()).reshape(-1) for n in names])

    tx = jax_optim.build_optimizer("adamw", jax_optim.constant_with_warmup(1e-3, 1), grad_clip_norm=10.0)
    js = JaxTrainState.create({"t": flat(old, trained), "f": flat(old, frozen)},
                              optax.masked(tx, {"t": True, "f": False}), ema=True)
    js = jax_nan_guard(js.apply_gradients, js, {"t": flat(jgrad, trained), "f": flat(jgrad, frozen)})

    model = ControlLDM(UNetBackbone(**TINY["unet"]), UNetBackbone(**TINY["controlnet"]))
    model.load_state_dict(case["model"].state_dict())
    model.requires_grad_(False)
    model.controlnet.requires_grad_(True)
    model.unet.output_blocks.requires_grad_(True)
    model.unet.out.requires_grad_(True)
    state = TrainState.create(model, optim.build_optimizer("adamw", optim.constant_with_warmup(1e-3, 1),
                                                           grad_clip_norm=10.0), ema=True)
    assert state.names == trained and frozen
    grads = dict(zip(old, eps_case["grads"]))
    assert bool(nan_guard(state, [grads[n] for n in state.names]))

    new = dict(model.named_parameters())
    got_t = np.concatenate([new[n].detach().numpy().reshape(-1) for n in trained])
    want_t, g_t = np.asarray(js.params["t"]), np.asarray(flat(jgrad, trained))
    # Adam's first step is about -lr sign(g): an element whose gradient is at rounding-noise level may step
    # either way in each package (2 lr apart at most); all others agree to 1e-3 lr
    diff = np.abs(got_t - want_t)
    signal = np.abs(g_t) > 1e-6 * np.abs(g_t).max()
    assert diff.max() <= 2.0001e-3 and (diff[signal] <= 1e-6).mean() >= 0.99
    for n in frozen:
        assert torch.equal(new[n].detach(), old[n]), n
    np.testing.assert_array_equal(np.asarray(js.params["f"]), np.asarray(flat(old, frozen)) + np.asarray(flat(jgrad, frozen)))


def test_samplers_step_the_controlled_unet(case):
    """The one-step sampler is z_T + v at t = T - 1; the Euler sampler adds
    v / 5 at 999, 799, 599, 349, 199."""
    task = case["task"]
    with torch.no_grad():
        z_T = torch.randn(case["latents"][0].shape, generator=torch.Generator().manual_seed(0))
        task.get_input = lambda batch: case["latents"]
        try:
            one = task.reflow_sample_1step(case["batch"], z_T=z_T)
            euler = task.reflow_sample_euler(case["batch"], z=z_T)
        finally:
            del task.get_input
        c, ctx = case["latents"][1], case["batch"]["context"]
        t = torch.full((2,), 999)
        torch.testing.assert_close(one, z_T + task.apply_model(z_T, t, ctx, c), rtol=0, atol=0)
        z = z_T
        for s in (999, 799, 599, 349, 199):
            z = z + task.apply_model(z, torch.full((2,), s), ctx, c) / 5
        torch.testing.assert_close(euler, z, rtol=0, atol=0)


def test_launcher_cldm_trains_resumes_and_takes_its_flags(tmp_path):
    """Two ``--task cldm`` steps on the CPU at the cldm_tiny widths with the
    loss-second-moment sampler and a context file, then a resume to step 3,
    then one ``--task reflow`` step: finite losses, frozen leaves as
    initialised, the trained ones moved, the context and the sampler's state
    (saved and restored) in effect."""
    from instarevive_tpu_torch.tools.time_train import write_images
    from instarevive_tpu_torch.train import checkpoint as ckpt
    from instarevive_tpu_torch.train import launcher

    data = write_images(str(tmp_path / "hq"), n=4, size=80)
    ctx = np.random.default_rng(0).standard_normal((3, 77, 32)).astype(np.float32)
    np.savez(tmp_path / "ctx.npz", feat=ctx)
    out = str(tmp_path / "run")
    common = ["--device", "cpu", "--config", TINY_PATH, "--data", data, "--out", out, "--batch_size", "2",
              "--crop_size", "64", "--log_every", "1", "--lr", "1e-3", "--warmup", "1", "--degradation", "codeformer",
              "--context_npz", str(tmp_path / "ctx.npz")]
    run = launcher.main(common + ["--task", "cldm", "--steps", "2", "--t_sampler", "loss_second_moment"])
    task = run.task
    assert isinstance(task, launcher.CLDMTask) and task.use_lsm and not task.reflow
    assert (run.start_step, run.end_step, len(run.history)) == (0, 2, 2)
    assert all(set(m) == {"loss", "grads_finite"} and np.isfinite(m["loss"]) and m["grads_finite"] == 1.0
               for m in run.history)
    np.testing.assert_array_equal(task.context.numpy(), np.repeat(ctx[:1], 2, axis=0))
    state, lsm = task.states
    assert int(lsm["counts"].sum()) == 4 and int(state.step) == 2  # two samples a step went into the history

    from instarevive_tpu_torch.models.unet import zero_init_
    from instarevive_tpu_torch.pipelines.build import init_params

    fresh = ControlLDM(UNetBackbone(**TINY["unet"]), UNetBackbone(**TINY["controlnet"]))  # the launcher's init, seed 0
    init_params(fresh, seed=0)
    zero_init_(fresh.unet), zero_init_(fresh.controlnet)
    init = dict(fresh.named_parameters())
    names = set(state.names)
    for name, p in task.model.named_parameters():
        trained = name.startswith(("controlnet.", "unet.output_blocks.", "unet.out."))
        assert (name in names) == trained == p.requires_grad, name
        if not trained:
            assert torch.equal(p, init[name]), name
    # behind the zero-initialised layers the gradient reaches one more layer a step: after two, the last conv
    # and the layers next to the UNet's output have moved
    moved = {n for n, p in task.model.named_parameters() if n in names and not torch.equal(p, init[n])}
    assert "unet.out.2.weight" in moved and len(moved) >= 10

    again = launcher.main(common + ["--task", "cldm", "--steps", "3", "--t_sampler", "loss_second_moment",
                                    "--resume", os.path.join(out, "final")])
    assert (again.start_step, again.end_step, len(again.history)) == (2, 3, 1)
    assert int(again.task.states[1]["counts"].sum()) == 6 and int(again.task.states[0].step) == 3
    saved = ckpt.load_checkpoint(os.path.join(out, "final"))
    assert saved["states"][0]["step"] == 3 and set(saved["states"][1]) == {"history", "counts"}

    refl = launcher.main(common + ["--task", "reflow", "--steps", "1", "--out", str(tmp_path / "reflow")])
    assert refl.task.reflow and refl.task.states[1] is None
    assert set(refl.history[0]) == {"loss", "reflow_mse", "grads_finite"} and np.isfinite(refl.history[0]["loss"])


def _pool_encode(img, cat, mean):
    """A stand-in for the frozen VAE in both packages: 8x8 average pooling,
    the channel mean as a fourth channel, scaled as the latents are."""
    b, h, w, c = img.shape
    x = mean(img.reshape(b, h // 8, 8, w // 8, 8, c), (2, 4))
    return cat([x, mean(x, (-1,))[..., None]], -1) * 0.18215


@pytest.mark.parametrize("variant", ["eps", "v", "x0", "inpaint", "upscale", "depth"])
def test_latent_diffusion_task_losses_match_jax(variant):
    """``train/ldm_tasks.py``: the base loss in its three parameterizations
    and the inpaint, upscale and depth2image conditionings, the VAE replaced
    by the same pooling in both packages, the draws from the JAX key."""
    from instarevive_tpu.train.ldm_tasks import LatentDiffusionTask as JaxLDM
    from instarevive_tpu_torch.train.ldm_tasks import LatentDiffusionTask

    in_ch = {"inpaint": 9, "upscale": 8, "depth": 5}.get(variant, 4)
    section = dict(in_channels=in_ch, out_channels=4, model_channels=32, num_res_blocks=1, attention_ds=[1],
                   channel_mult=[1], num_head_channels=16, context_dim=32)
    rng = np.random.default_rng(11)
    b = 2
    batch = {"hq": rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32),
             "context": rng.standard_normal((b, 4, 32)).astype(np.float32),
             "mask": (rng.random((b, 64, 64, 1)) < 0.3).astype(np.float32),
             "lq": rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
             "depth": rng.random((b, 48, 48, 1)).astype(np.float32)}
    ju = JaxUNet(**_jax_cfg(section))
    params = _random_params(ju, 5, np.zeros((b, 8, 8, in_ch), np.float32), np.zeros(b, np.float32), batch["context"])

    class _Vae:
        ch_mult = (1, 2, 4, 4)

    param = variant if variant in ("v", "x0") else "eps"
    jtask = JaxLDM(ju, _Vae(), jax_make_schedule("ldm_linear", 1000), parameterization=param)
    jtask.encode = lambda frozen, img: _pool_encode(img, jnp.concatenate, lambda x, ax: x.mean(ax))
    key = jax.random.key(4)
    fn = {"inpaint": jtask.inpaint_loss, "upscale": jtask.upscale_loss, "depth": jtask.depth2image_loss}.get(
        variant, jtask.loss)
    jloss, _ = fn({"unet": params}, None, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    t_rng, n_rng = jax.random.split(key)
    t = jax.random.randint(t_rng, (b,), 0, 1000)
    noise = jax.random.normal(n_rng, (b, 8, 8, 4))

    unet = UNetBackbone(**section)
    unet.load_state_dict(_export(params, section), strict=True)
    task = LatentDiffusionTask(unet, _Vae(), make_schedule("ldm_linear", 1000), parameterization=param)
    task.encode = lambda img: _pool_encode(img, torch.cat, lambda x, ax: x.mean(ax))
    tfn = {"inpaint": task.inpaint_loss, "upscale": task.upscale_loss, "depth": task.depth2image_loss}.get(
        variant, task.loss)
    with torch.no_grad():
        loss, metrics = tfn({k: torch.from_numpy(v) for k, v in batch.items()}, t=torch.from_numpy(np.asarray(t)).long(),
                            noise=torch.from_numpy(np.asarray(noise)))
    assert _rel(loss.item(), float(jloss)) <= LOSS_REL and "loss_simple" in metrics
