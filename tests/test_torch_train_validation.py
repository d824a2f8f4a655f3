"""The port's training-validation tools (instarevive_tpu_torch/tools/
train_validation.py, train_validation_prod.py, download.py) against the JAX
package's root tools on the CPU: the procedural fields fed the very draws
JAX makes from one key; one teacher step, one Reflow step and the one-step
quality row of the toy's composition, and two DMD steps of the production
tool's (regression 0.25, fake lr x5, bf16 moments and EMA, a bf16-rounded
teacher), with weights carried across by ``convert/from_jax`` at hidden 64,
depth 2, head dims 32 and 64; the production eval's decode and NIQE on a
tiny VAE; each tool's ``main`` at small flags; the timing tool's probe;
``find_model``.

The DiTs compute in f32 on both sides (the tools run bf16 compute at
production width; the two frameworks round bf16 at other places, and the
point here is the composition)."""

import copy
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.diffusion import gaussian as jax_gaussian
from instarevive_tpu.diffusion.one_step import eps_to_x0 as jax_eps_to_x0
from instarevive_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from instarevive_tpu.models.pixart import PixArt as JaxPixArt
from instarevive_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from instarevive_tpu.pipelines.restore import VAE_SCALE as JAX_VAE_SCALE
from instarevive_tpu.train import distill as jax_distill
from instarevive_tpu.train import optim as jax_optim
from instarevive_tpu.train.state import TrainState as JaxTrainState
from instarevive_tpu.utils import metrics as jax_metrics
from instarevive_tpu.utils import niqe as jax_niqe
from instarevive_tpu_torch.convert.from_jax import pixart_params_to_torch, vae_params_to_torch
from instarevive_tpu_torch.models.pixart import PixArt
from instarevive_tpu_torch.models.vae import AutoencoderKL
from instarevive_tpu_torch.nn.layers import set_compute_dtype
from instarevive_tpu_torch.tools import download
from instarevive_tpu_torch.tools import train_validation as tv
from instarevive_tpu_torch.tools import train_validation_prod as tvp
from instarevive_tpu_torch.train.state import TrainState
from instarevive_tpu_torch.utils import niqe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
try:
    import train_validation as jax_tv  # the JAX package's root tools
    import train_validation_prod as jax_tvp
finally:
    sys.path.pop(0)

# The toy's DiT at test width: 16x16x3 images in 4x4 patches (16 tokens), hidden 64 over 2 or 1 heads.
TOY = dict(input_size=16, patch_size=4, in_channels=3, hidden_size=64, depth=2, caption_channels=16,
           model_max_length=4, mlp_ratio=2.0)
HEADS = {32: 2, 64: 1}  # head dim -> heads at hidden 64
B = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _torch_dit(params, cfg, **kw):
    model = PixArt(**cfg, **kw)
    model.load_state_dict({k: _t(v) for k, v in pixart_params_to_torch(_np(params), depth=cfg["depth"]).items()})
    return model


def _assert_params_close(names, tensors, want):
    """After one or two Adam steps: an element whose gradient is rounding
    noise may step either way in each package, 3e-5 apart at most (lr up to
    1e-3 in a first step's warm-up); all others agree to 2e-6 (the bounds of
    tests/test_torch_train.py)."""
    close = total = 0
    for name, p in zip(names, tensors):
        diff = np.abs(p.detach().float().numpy() - want[name])
        assert diff.max() <= 4e-5, name
        close, total = close + int((diff <= 2e-6).sum()), total + diff.size
    assert close >= 0.99 * total, (close, total)


# ---------------------------------------------------------------------------
# the procedural fields


@pytest.mark.parametrize("which", ["synth_batch", "synth_latents"])
def test_field_functions_match_jax_on_its_draws(which):
    """The port's field function, fed the draws JAX makes from one key (split
    as the JAX tools split it), against ``synth_batch`` / ``synth_latents``:
    within 1e-6."""
    key = jax.random.key(7)
    b, size, ch = (3, 32, 3) if which == "synth_batch" else (2, 16, 4)
    want = jax_tv.synth_batch(key, b, size) if ch == 3 else jax_tvp.synth_latents(key, b, size, ch)
    k1, k2, k3 = jax.random.split(key, 3)
    base = jax.random.normal(k1, (b, 4, 4, ch))
    theta = jax.random.uniform(k2, (b, 1, 1)) * jnp.pi
    amp = jax.random.uniform(k3, (b, 1, 1, 1), minval=0.2, maxval=0.8)
    got = tv.synth_field(_t(base), _t(theta), _t(amp), size)
    assert got.shape == (b, size, size, ch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the port's own draws: the same distribution's support
    g = torch.Generator().manual_seed(0)
    x = tv.synth_batch(g, b, size, ch) if ch == 3 else tvp.synth_latents(g, b, size, ch)
    assert x.shape == (b, size, size, ch) and x.abs().max() < 1


# ---------------------------------------------------------------------------
# the toy's teacher step, Reflow step and quality row


@pytest.fixture(scope="module", params=sorted(HEADS), ids=lambda d: f"head_dim_{d}")
def toy(request):
    """The toy DiT at one head dim in both packages, the same weights."""
    cfg = dict(TOY, num_heads=HEADS[request.param])
    dit = JaxPixArt(**cfg)
    y = jnp.zeros((B, 4, 16))
    params = jax.jit(dit.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)), y[:1])["params"]

    def eps_fn(p, x, t, **cond):  # as the JAX tool composes it
        return dit.apply({"params": p}, x, t.astype(jnp.float32), cond.get("y", y[: x.shape[0]]))[..., :3]

    return SimpleNamespace(cfg=cfg, params=params, eps_fn=eps_fn, y=y, ty=torch.zeros(B, 4, 16),
                           jsched=jax_make_schedule("linear", 1000))


def _port_sched():
    from instarevive_tpu_torch.diffusion.schedules import make_schedule

    return make_schedule("linear", 1000)


def test_teacher_step_matches_jax(toy):
    """One step of stage A (DDPM eps-MSE, AdamW 2e-4 warm-up 100, clip 1, EMA
    0.999) on the draws of one JAX key: the loss within 1e-5 of itself, the
    parameters and the EMA after the step as the DMD tests hold them."""
    key = jax.random.key(3)
    kd, kt, kn = jax.random.split(key, 3)
    x0 = jax.jit(jax_tv.synth_batch, static_argnums=(1, 2))(kd, B, 16)
    t = jax.random.randint(kt, (B,), 0, 1000)
    noise = jax.random.normal(kn, x0.shape)
    x_t = jax_gaussian.q_sample(toy.jsched, x0, t, noise)
    loss_fn = lambda p: jnp.mean((toy.eps_fn(p, x_t, t) - noise) ** 2)  # noqa: E731
    tx = jax_optim.build_optimizer("adamw", jax_optim.constant_with_warmup(2e-4, 100), grad_clip_norm=1.0)
    js = JaxTrainState.create(toy.params, tx, ema=True, ema_rate=0.999)

    def step(state):  # jitted, as the JAX tool's chunk of steps
        loss, g = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(g), loss

    js, want_loss = jax.jit(step)(js)

    model = _torch_dit(toy.params, toy.cfg)
    ts = TrainState.create(model, tv.adamw(2e-4, 100, 1.0), ema=True, ema_rate=0.999)
    got_loss = tv.teacher_step(ts, tv.model_fn(model, toy.ty), _port_sched(), _t(x0), _t(t).long(), _t(noise))
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    _assert_params_close(ts.names, ts.params, pixart_params_to_torch(_np(js.params), depth=2))
    _assert_params_close(ts.names, ts.ema_params, pixart_params_to_torch(_np(js.ema_params), depth=2))


def test_reflow_step_matches_jax(toy):
    """One step of stage C (``reflow_loss`` on a fresh batch, AdamW 2e-4,
    clip 1, EMA 0.999) on the draws of one JAX key."""
    key = jax.random.key(5)
    kd, kl = jax.random.split(key)
    z0 = jax.jit(jax_tv.synth_batch, static_argnums=(1, 2))(kd, B, 16)
    t_rng, n_rng = jax.random.split(kl)  # as reflow_loss splits its key
    t = jax.random.randint(t_rng, (B,), 1, 1000)
    z_T = jax.random.normal(n_rng, z0.shape)
    tx = jax_optim.build_optimizer("adamw", jax_optim.constant_with_warmup(2e-4, 100), grad_clip_norm=1.0)
    js = JaxTrainState.create(toy.params, tx, ema=True, ema_rate=0.999)

    def step(state):  # jitted, as the JAX tool's chunk of steps
        (_, metrics), g = jax.value_and_grad(
            lambda p: jax_distill.reflow_loss(toy.jsched, toy.eps_fn, p, z0, kl, {"y": toy.y}), has_aux=True)(state.params)
        return state.apply_gradients(g), metrics

    js, metrics = jax.jit(step)(js)

    model = _torch_dit(toy.params, toy.cfg)
    ts = TrainState.create(model, tv.adamw(2e-4, 100, 1.0), ema=True, ema_rate=0.999)
    mse = tv.reflow_step(ts, tv.model_fn(model, toy.ty), _port_sched(), _t(z0), _t(t).long(), _t(z_T), {"y": toy.ty})
    want = float(metrics["reflow_mse"])
    assert abs(float(mse) - want) <= 1e-5 * want
    _assert_params_close(ts.names, ts.params, pixart_params_to_torch(_np(js.params), depth=2))


def test_quality_row_matches_jax(toy):
    """The 1-step quality row: eps_to_x0 at t = 400 from held noise against
    a target, both mapped to [0, 1], mean PSNR within 1e-4 dB and SSIM within
    1e-5 of the JAX tool's composition."""
    rng = np.random.default_rng(9)
    noise = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    target = np.tanh(rng.standard_normal((B, 16, 16, 3))).astype(np.float32)
    t400 = jnp.full((B,), 400, jnp.int32)
    onestep = jax.jit(lambda p, z: jax_eps_to_x0(toy.jsched, toy.eps_fn(p, z, t400), z, t400))  # as the JAX tool
    gen = onestep(toy.params, jnp.asarray(noise))
    gen01, tgt01 = jnp.clip((gen + 1) / 2, 0, 1), jnp.clip((jnp.asarray(target) + 1) / 2, 0, 1)
    want = float(jax_metrics.psnr(gen01, tgt01).mean()), float(jax_metrics.ssim(gen01, tgt01).mean())

    model = _torch_dit(toy.params, toy.cfg)
    got = tv.quality(_port_sched(), tv.model_fn(model, toy.ty), _t(noise), _t(target))
    assert abs(got[0] - want[0]) <= 1e-4 and abs(got[1] - want[1]) <= 1e-5, (got, want)


# ---------------------------------------------------------------------------
# two DMD steps of the production tool's composition


def _draws_from_key(rng, b, shape, T=1000, min_dm_t=20, max_dm_t=979):
    """The draws of one JAX DMD step, split as train/distill.py splits them."""
    g_rng, f_rng = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(g_rng)
    out = {"t_dm": jax.random.randint(t_rng, (b,), min_dm_t, max_dm_t), "noise_dm": jax.random.normal(n_rng, shape)}
    t_rng, n_rng = jax.random.split(f_rng)
    out.update(t_fake=jax.random.randint(t_rng, (b,), 0, T), noise_fake=jax.random.normal(n_rng, shape))
    return {k: _t(v).long() if k.startswith("t_") else _t(v) for k, v in out.items()}


@pytest.mark.parametrize("head_dim", sorted(HEADS))
def test_prod_dmd_steps_match_jax(head_dim):
    """Two steps of the production tool's DMD composition (``dmd_states``,
    ``dmd_step_fn``, a bf16-rounded teacher) at its --tiny geometry, hidden
    64 over 2 or 1 heads, against ``make_dmd_train_step`` composed as the JAX
    tool composes it: metrics within 1e-5 of themselves, parameters as the
    DMD tests hold them, the bf16 moments and the bf16 EMA shadow within the
    two bf16 roundings of two steps."""
    args = tvp.parse_args(["--tiny", "--device", "cpu"])
    geo = tvp.geometry(True)
    geo["dit"] = dict(geo["dit"], num_heads=HEADS[head_dim])
    size, tokens, cap, bd = geo["size"], geo["tokens"], geo["cap"], args.dmd_batch
    dit = JaxPixArt(**geo["dit"])
    params = jax.jit(dit.init)(jax.random.key(1), jnp.zeros((1, size, size, 4)), jnp.zeros((1,)),
                               jnp.zeros((1, tokens, cap)))["params"]

    def eps_fn(p, x, t, **cond):
        y = cond.get("y")
        if y is None or y.shape[0] != x.shape[0]:
            y = jnp.zeros((x.shape[0], tokens, cap), jnp.float32)
        return dit.apply({"params": p}, x, t.astype(jnp.float32), y)[..., :4].astype(jnp.float32)

    teacher_p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    f32 = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), t)  # noqa: E731
    opt = lambda lr: jax_optim.build_optimizer("adamw", jax_optim.constant_with_warmup(lr, 100),  # noqa: E731
                                               grad_clip_norm=10.0, moment_dtype=jnp.bfloat16)
    jgen = JaxTrainState.create(f32(teacher_p), opt(args.dmd_lr), ema=True, ema_rate=args.ema_rate,
                                ema_dtype=jnp.bfloat16)
    jfake = JaxTrainState.create(f32(teacher_p), opt(args.dmd_lr * args.lr_fake_multiplier), ema=False)
    jstep = jax.jit(jax_distill.make_dmd_train_step(jax_make_schedule("linear", 1000), eps_fn,
                                            lambda z, t, **c: eps_fn(teacher_p, z, t, **c), eps_fn, JaxTrainState,
                                            maxt=args.maxt, regression_weight=0.25))
    rng = np.random.default_rng(2)
    batch = {"noise": rng.standard_normal((bd, size, size, 4), dtype=np.float32),
             "latent": np.tanh(rng.standard_normal((bd, size, size, 4))).astype(np.float32)}
    y = jnp.zeros((bd, tokens, cap))
    keys = [jax.random.key(21), jax.random.key(22)]
    jmetrics = []
    for key in keys:
        jgen, jfake, m = jstep(jgen, jfake, {k: jnp.asarray(v) for k, v in batch.items()}, key, {"y": y})
        jmetrics.append({k: float(v) for k, v in m.items()})

    run = tvp.Run(geo, "cpu", seed=0, dtype=None)
    run.dit.load_state_dict({k: _t(v) for k, v in pixart_params_to_torch(_np(params), depth=2).items()})
    teacher = set_compute_dtype(tvp.frozen_bf16(run.dit), torch.float32)  # f32 compute from bf16 weights, as flax
    gen = tvp.load_f32(run.dit.requires_grad_(True).train(), teacher)  # as main: the generator from the teacher
    fake = copy.deepcopy(gen)
    gen_state, fake_state = tvp.dmd_states(run, gen, fake, args)
    step = tvp.dmd_step_fn(run, gen, fake, teacher, args)
    for key, want in zip(keys, jmetrics):
        got = step(gen_state, fake_state, {k: _t(v) for k, v in batch.items()}, None, {"y": run.zeros_y(bd)},
                   draws=_draws_from_key(key, bd, (bd, size, size, 4)))
        for k in ("regression", "dm", "fake_score"):
            assert abs(float(got[k]) - want[k]) <= 1e-5 * abs(want[k]) + 1e-9, (k, float(got[k]), want[k])
    assert jmetrics[1]["dm"] > 1e-7  # the second step's fake score differs from the teacher: DM is exercised
    for js, ts in ((jgen, gen_state), (jfake, fake_state)):
        _assert_params_close(ts.names, ts.params, pixart_params_to_torch(_np(js.params), depth=2))
        adam = [s for s in jax.tree_util.tree_leaves(js.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if
                hasattr(s, "mu")][0]
        for name, got in zip(ts.names, ts.opt_state["inner"]["mu"]):
            assert got.dtype == torch.bfloat16
            want = pixart_params_to_torch(_np(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), adam.mu)),
                                          depth=2)[name]
            # bf16 moments: each package rounds its f32 update to bf16 in each of the two steps, so two bf16 steps
            # (a step is at most 2^-7 of the value) apart at most, on top of the gradients' differences: 2e-4 of
            # the largest magnitude (nu's bound in tests/test_torch_train.py; step 2's DM gradient carries the
            # 1 / mean|x0 - x0_real| normaliser, which scales the packages' f32 differences; measured 1.1e-4)
            # (a moment whose gradient is rounding noise, under 1e-12 (the zero caption's cross-attention
            # queries), is held by the parameters' check only, as in tests/test_torch_train.py)
            scale = np.abs(want).max()
            bad = np.abs(got.float().numpy() - want) > 2**-6 * np.abs(want) + 2e-4 * scale
            assert scale < 1e-12 or not bad.any(), (name, got.float().numpy()[bad][:5], want[bad][:5], scale)
    want_ema = pixart_params_to_torch(_np(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jgen.ema_params)),
                                      depth=2)
    for name, e in zip(gen_state.names, gen_state.ema_params):
        assert e.dtype == torch.bfloat16
        diff = np.abs(e.float().numpy() - want_ema[name])
        assert np.all(diff <= 2**-6 * np.abs(want_ema[name]) + 1e-6), name  # two roundings: two bf16 steps


# ---------------------------------------------------------------------------
# the production eval on a tiny VAE


def test_prod_eval_decode_and_niqe_match_jax():
    """The eval's pixel path at the tool's --tiny geometry, f32: the VAE
    decode of z / VAE_SCALE in chunks of 2 (a last odd sample dropped)
    within 1e-5 of the JAX decode, and NIQE at block 8 with the pristine
    model fitted on those decodes against the JAX package's
    (``fit_pristine_model``, ``_to_gray_255``, ``niqe``) on the same images.
    At block 8 a 32x32 image gives 16 blocks, so the pristine model's 36 x 36
    covariance comes from 32 feature rows and its pseudo-inverse magnifies
    the two packages' f32 rounding: the model's mean within 1e-4 relative
    (measured 1.6e-5), the scores within 1e-3 relative (measured 7e-5); at
    block 96 on larger images tests/test_torch_iqa.py holds them to 1e-6."""
    geo = tvp.geometry(True)
    vae_kw = geo["vae"]
    jvae = JaxAutoencoderKL(**vae_kw)
    vparams = jax.jit(jvae.init)(jax.random.key(7), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(4)
    z = np.tanh(rng.standard_normal((5, 16, 16, 4))).astype(np.float32)
    decode = jax.jit(lambda z: jvae.apply({"params": vparams}, z / JAX_VAE_SCALE, method=jvae.decode))
    want = np.concatenate([np.clip((np.asarray(decode(jnp.asarray(z[i:i + 2]))) + 1.0) / 2.0, 0.0, 1.0)
                           for i in (0, 2)])
    vae = AutoencoderKL(**vae_kw)
    vae.load_state_dict({k: _t(v) for k, v in vae_params_to_torch(_np(vparams), ch_mult=vae_kw["ch_mult"],
                                                                    num_res_blocks=vae_kw["num_res_blocks"]).items()})
    got = tvp.decode01(vae.to(memory_format=torch.channels_last).eval(), _t(z))
    assert got.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    bs = geo["block_size"]
    pris = niqe.fit_pristine_model([niqe._to_gray_255(im) for im in want[:2]], bs)
    jpris = jax_niqe.fit_pristine_model([jax_niqe._to_gray_255(im) for im in want[:2]], bs)
    np.testing.assert_allclose(pris.mu, jpris.mu, rtol=1e-4)
    got_scores, want_scores = (tvp.niqe_mean(want[2:], pris, bs),
                               float(np.mean([jax_niqe.niqe(im, jpris, bs) for im in want[2:]])))
    assert np.isfinite(got_scores) and abs(got_scores - want_scores) <= 1e-3 * abs(want_scores)


# ---------------------------------------------------------------------------
# the tools end to end


def test_prod_main_tiny_writes_its_tables(tmp_path):
    """``main --tiny`` on the CPU at a few steps: every stage, the teacher's
    assert, the three generator rows, the markdown appended."""
    out = tmp_path / "prod.md"
    out.write_text("before\n")
    r = tvp.main(["--tiny", "--device", "cpu", "--out", str(out), "--teacher_steps", "60", "--dmd_steps", "20",
                  "--chunk", "10"])
    text = out.read_text()
    assert text.startswith("before\n")
    for heading in ("Stage A — teacher", "Stage B — DMD", "| generator | latent PSNR"):
        assert heading in text
    assert len(r["results"]) == 3 and all(np.isfinite(v).all() for v in r["results"].values())
    assert len(r["curves"]["teacher"]) == 6 and len(r["curves"]["dmd"]) == 2


def test_toy_main_writes_its_tables_with_every_assert(tmp_path):
    """``main`` of the toy tool on the CPU at small flags at which its own
    asserts hold, about a minute: 16x16 images in 2x2 patches, hidden 64 over
    2 heads (head dim 32), batch 16, 1,000 teacher steps (a teacher whose
    20-step samples stay in range; at a few hundred they diverge, in the JAX
    tool as here), 500 DMD and 200 Reflow steps. Every stage's table and the
    figures it returns; a second call refuses TRAINVAL.md, the JAX package's
    record."""
    out = tmp_path / "toy.md"
    r = tv.main(["--device", "cpu", "--out", str(out), "--batch", "16", "--size", "16", "--hidden", "64",
                 "--depth", "1", "--heads", "2", "--patch", "2", "--teacher_steps", "1000", "--dmd_steps", "500",
                 "--reflow_steps", "200", "--log_every", "100"])
    text = out.read_text()
    for heading in ("Stage A — teacher", "Stage B — DMD", "| EMA after DMD", "Stage C — Reflow", "EMA after reflow"):
        assert heading in text
    assert r["psnr"]["ema"] > r["psnr"]["init"] and r["reflow_moment_dist"]["ema"] < r["reflow_moment_dist"]["init"]
    assert set(r["walls"]) == {"teacher", "pairs", "dmd", "quality", "reflow", "reflow_eval"}
    with pytest.raises(SystemExit, match="TRAINVAL.md"):
        tv.main(["--device", "cpu", "--out", "TRAINVAL.md"])


def test_time_train_validation_probe_reads_each_chunk():
    """The timing tool's ``--probe`` on the CPU at toy flags: the tool's
    stages with the DMD EMA's quality and the Reflow EMA's moment distance
    read after every chunk (the stages' ``on_chunk`` hook), finite."""
    from instarevive_tpu_torch.tools import time_train_validation as ttv

    r = ttv.main(["--probe", "--every", "10", "--device", "cpu", "--batch", "4", "--size", "16", "--hidden", "64",
                  "--depth", "1", "--heads", "2", "--patch", "4", "--teacher_steps", "20", "--dmd_steps", "20",
                  "--reflow_steps", "30"])
    assert [i for i, *_ in r["dmd_ema"]] == [9, 19] and [i for i, _ in r["reflow_ema"]] == [9, 19, 29]
    assert len(r["teacher_curve"]) == 2 and r["card"] == "cpu"
    assert np.isfinite([v for row in r["dmd_ema"] for v in row] + [d for _, d in r["reflow_ema"]]).all()


def test_find_model_local(tmp_path):
    """``find_model`` loads a local path; a missing registry name raises with
    the upstream URL; a missing path raises. The CLI lists what is missing."""
    path = tmp_path / "custom.pth"
    torch.save({"state_dict": {"w": torch.ones(2)}}, str(path))
    sd = download.find_model(str(path))
    assert torch.equal(sd["state_dict"]["w"], torch.ones(2))
    with pytest.raises(FileNotFoundError, match="huggingface"):
        download.find_model("PixArt-Sigma-XL-2-512-MS.pth", model_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="Could not find"):
        download.find_model(str(tmp_path / "nope.pth"))
    torch.save({"w": torch.zeros(1)}, str(tmp_path / "InstaRevive_v1.ckpt"))
    assert torch.equal(download.find_model("InstaRevive_v1.ckpt", model_dir=str(tmp_path))["w"], torch.zeros(1))
    assert download.main(["--model_dir", str(tmp_path)]) == sorted(download.PRETRAINED_MODELS - {"InstaRevive_v1.ckpt"})
