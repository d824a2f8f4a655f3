"""The port's training path (instarevive_tpu_torch/train/, diffusion/gaussian.py,
data/, utils/) against the JAX package on the CPU, at the widths of
tests/test_learning.py (hidden 64, depth 2, 4 heads): the same weights (through
``convert/from_jax``), batch and draws (taken from the JAX key exactly as
``train/distill.py`` splits it) through ``make_dmd_train_step`` of both
packages; every optimizer and schedule against optax; accumulation, EMA,
checkpoints, the loader and the launcher."""

import math
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
import optax

from instarevive_tpu.diffusion import gaussian as jax_gaussian
from instarevive_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from instarevive_tpu.models.pixart import PixArt as JaxPixArt
from instarevive_tpu.train import distill as jax_distill
from instarevive_tpu.train import optim as jax_optim
from instarevive_tpu.train.state import TrainState as JaxTrainState
from instarevive_tpu_torch.convert.from_jax import (
    pixart_params_to_torch, swinir_params_to_torch, swinir_train_state_from_jax, train_state_from_jax,
)
from instarevive_tpu_torch.diffusion import gaussian
from instarevive_tpu_torch.diffusion.one_step import eps_to_x0
from instarevive_tpu_torch.diffusion.schedules import make_schedule
from instarevive_tpu_torch.models.pixart import PixArt
from instarevive_tpu_torch.nn.layers import set_compute_dtype
from instarevive_tpu_torch.train import checkpoint as ckpt
from instarevive_tpu_torch.train import distill, optim
from instarevive_tpu_torch.train.state import TrainState

DIT = dict(input_size=8, patch_size=2, hidden_size=64, depth=2, num_heads=4,
           caption_channels=32, model_max_length=8, mlp_ratio=2.0)
SMALL = dict(DIT, hidden_size=32, depth=1, num_heads=2, caption_channels=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rel(a, b):
    """max |a - b| over the largest magnitude of b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_dit(cfg=DIT, seed=0, batch=2):
    dit = JaxPixArt(**cfg)
    y = jnp.zeros((batch, cfg["model_max_length"], cfg["caption_channels"]))
    params = dit.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), y[:1])["params"]

    def gen_fn(p, z, t, **cond):
        return dit.apply({"params": p}, z, t.astype(jnp.float32), cond["y"])[..., : z.shape[-1]]

    return dit, params, gen_fn


def _torch_dit(params, cfg=DIT, **kw):
    model = PixArt(**cfg, **kw)
    model.load_state_dict({k: _t(v) for k, v in pixart_params_to_torch(_np(params), depth=cfg["depth"]).items()})
    return model


def _fn(model):
    def fn(z, t, **cond):
        return model(z, t.float(), cond["y"])[..., : z.shape[-1]]
    return fn


def _batch(b=2, seed=1):
    rng = np.random.default_rng(seed)
    return {"noise": rng.standard_normal((b, 8, 8, 4), dtype=np.float32),
            "latent": 0.3 * rng.standard_normal((b, 8, 8, 4), dtype=np.float32)}


def _draws_from_key(rng, b, shape, T=1000, min_dm_t=20, max_dm_t=979):
    """The draws of one JAX train step, split as train/distill.py splits them."""
    g_rng, f_rng = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(g_rng)
    out = {"t_dm": jax.random.randint(t_rng, (b,), min_dm_t, max_dm_t), "noise_dm": jax.random.normal(n_rng, shape)}
    t_rng, n_rng = jax.random.split(f_rng)
    out.update(t_fake=jax.random.randint(t_rng, (b,), 0, T), noise_fake=jax.random.normal(n_rng, shape))
    return {k: _t(np.asarray(v)).long() if k.startswith("t_") else _t(np.asarray(v)) for k, v in out.items()}


def _assert_params_close(state, want, tensors=None):
    """Two Adam steps at lr 1e-5 and 2e-5. An element whose gradient is rounding noise (the key bias
    of an attention has none analytically) may step either way in each package, 3e-5 apart at most;
    all others agree to 2e-6."""
    close = total = 0
    for name, p in zip(state.names, state.params if tensors is None else tensors):
        diff = np.abs(p.detach().numpy() - want[name])
        assert diff.max() <= 4e-5, name
        close, total = close + int((diff <= 2e-6).sum()), total + diff.size
    assert close >= 0.99 * total, (close, total)


def _named(state, tensors):
    return dict(zip(state.names, tensors))


def _adam_state(opt_state):
    """The ScaleByAdamState inside an optax chain's state."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
             if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0]


# ---------------------------------------------------------------------------
# diffusion/gaussian.py


def test_gaussian_closed_forms_match_jax():
    rng = np.random.default_rng(0)
    x, n = (rng.standard_normal((3, 8, 8, 4), dtype=np.float32) for _ in range(2))
    t = np.array([0, 400, 999])
    js, ts = jax_make_schedule("linear", 1000), make_schedule("linear", 1000)
    for name in ("q_sample", "predict_xstart_from_eps", "predict_eps_from_xstart"):
        want = getattr(jax_gaussian, name)(js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(n))
        got = getattr(gaussian, name)(ts, _t(x), _t(t), _t(n))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the DMD step against the JAX package


@pytest.fixture(scope="module")
def dmd_pair():
    """Two JAX train steps and the same two steps of the port, with the
    gradients of step one."""
    jsched, tsched = jax_make_schedule("linear", 1000), make_schedule("linear", 1000)
    _, params, gen_fn = _jax_dit()
    fake_params = jax.tree_util.tree_map(lambda x: x * 1.01, params)  # a fake score that differs from the teacher
    y = np.random.default_rng(5).standard_normal((2, 8, 32)).astype(np.float32)
    y_null = np.random.default_rng(6).standard_normal((8, 32)).astype(np.float32)
    batch = _batch()

    def teacher_fn(z, t, **c):
        return gen_fn(params, z, t, **c)

    real_fn = jax_distill.make_cfg_real_fn(teacher_fn, jnp.asarray(y_null), 3.0)
    tx = lambda: jax_optim.build_optimizer("adamw", jax_optim.constant_with_warmup(1e-4, 10), grad_clip_norm=10.0)  # noqa: E731
    jgen = JaxTrainState.create(params, tx(), ema=True)
    jfake = JaxTrainState.create(fake_params, tx(), ema=False)
    jstep = jax.jit(jax_distill.make_dmd_train_step(jsched, gen_fn, real_fn, gen_fn, JaxTrainState))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = [jax.random.key(11), jax.random.key(12)]

    # the JAX gradients of step one, by the same losses the step differentiates
    g_rng, f_rng = jax.random.split(keys[0])
    (_, (_, x0_gen)), jg = jax.value_and_grad(
        lambda p: jax_distill.dmd_generator_loss(jsched, gen_fn, real_fn, gen_fn, p, fake_params, jbatch, g_rng,
                                                 cond={"y": jnp.asarray(y)}), has_aux=True)(params)
    jf = jax.grad(lambda p: jax_distill.dmd_fake_score_loss(jsched, gen_fn, p, x0_gen, f_rng, {"y": jnp.asarray(y)}))(fake_params)

    jmetrics, jstates = [], []
    for key in keys:
        jgen, jfake, m = jstep(jgen, jfake, jbatch, key, {"y": jnp.asarray(y)})
        jmetrics.append({k: float(v) for k, v in m.items()})
        jstates.append((jgen, jfake))

    gen, fake, teacher = _torch_dit(params), _torch_dit(fake_params), _torch_dit(params).requires_grad_(False)
    ttx = lambda: optim.build_optimizer("adamw", optim.constant_with_warmup(1e-4, 10), grad_clip_norm=10.0)  # noqa: E731
    tgen, tfake = TrainState.create(gen, ttx(), ema=True), TrainState.create(fake, ttx(), ema=False)
    tstep = distill.make_dmd_train_step(
        tsched, _fn(gen), distill.make_cfg_real_fn(_fn(teacher), _t(y_null), 3.0), _fn(fake))
    tbatch = {k: _t(v) for k, v in batch.items()}
    tmetrics, grads = [], {}
    for i, key in enumerate(keys):
        kept = {}
        m = tstep(tgen, tfake, tbatch, None, {"y": _t(y)}, draws=_draws_from_key(key, 2, (2, 8, 8, 4)), keep_grads=kept)
        tmetrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {k: _named(s, v) for (k, v), s in zip(kept.items(), (tgen, tfake))}
    return dict(jmetrics=jmetrics, tmetrics=tmetrics, jgrads={"generator": jg, "fake": jf}, tgrads=grads,
                jstates=jstates, tstates=(tgen, tfake), params=params, y=y, batch=batch, keys=keys)


@pytest.mark.parametrize("step", [0, 1])
def test_dmd_step_metrics_match_jax(dmd_pair, step):
    for k, want in dmd_pair["jmetrics"][step].items():
        got = dmd_pair["tmetrics"][step][k]
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (k, got, want)
    assert dmd_pair["jmetrics"][step]["dm"] > 1e-6  # the distribution-matching term is exercised


@pytest.mark.parametrize("which", ["generator", "fake"])
def test_dmd_step_gradients_match_jax(dmd_pair, which):
    want = pixart_params_to_torch(_np(dmd_pair["jgrads"][which]), depth=2)
    got = dmd_pair["tgrads"][which]
    scale = max(np.abs(v).max() for v in want.values())
    assert scale > 0
    for name, g in got.items():
        assert np.abs(g.numpy() - want[name]).max() <= 1e-4 * scale, name


def test_dmd_adam_moments_and_ema_after_two_steps_match_jax(dmd_pair):
    (jgen, jfake), (tgen, tfake) = dmd_pair["jstates"][1], dmd_pair["tstates"]
    for js, ts in ((jgen, tgen), (jfake, tfake)):
        adam = _adam_state(js.opt_state)
        assert int(adam.count) == ts.opt_state["inner"]["count"] == 2 and int(js.step) == ts.step == 2
        for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
            want = pixart_params_to_torch(_np(tree), depth=2)
            for name, got in _named(ts, ts.opt_state["inner"][key]).items():
                # the moments are sums of gradients and of their squares, so they are held as the
                # gradients are (1e-4 of the largest magnitude; nu, a square, twice that); measured 1.5e-5
                tol = 1e-4 if key == "mu" else 2e-4
                assert _rel(got.numpy(), want[name]) <= tol or np.abs(want[name]).max() < 1e-12, (key, name)
        _assert_params_close(ts, pixart_params_to_torch(_np(js.params), depth=2))
    _assert_params_close(tgen, pixart_params_to_torch(_np(jgen.ema_params), depth=2), tgen.ema_params)  # a mix of the params
    assert tfake.ema_params is None


def test_train_state_carried_across_from_jax_continues_the_jax_run(dmd_pair):
    """The JAX state after step one, loaded through ``train_state_from_jax``,
    takes step two in the port and lands where the JAX package's did."""
    jgen1, jfake1 = dmd_pair["jstates"][0]
    jgen2, _ = dmd_pair["jstates"][1]
    tsched = make_schedule("linear", 1000)
    gen, fake, teacher = (_torch_dit(dmd_pair["params"]) for _ in range(3))
    teacher.requires_grad_(False)
    ttx = lambda: optim.build_optimizer("adamw", optim.constant_with_warmup(1e-4, 10), grad_clip_norm=10.0)  # noqa: E731
    tgen, tfake = TrainState.create(gen, ttx(), ema=True), TrainState.create(fake, ttx(), ema=False)
    for js, ts in ((jgen1, tgen), (jfake1, tfake)):
        adam = _adam_state(js.opt_state)
        tree = train_state_from_jax(_np(js.params), None if js.ema_params is None else _np(js.ema_params),
                                    _np(adam.mu), _np(adam.nu), int(adam.count), ts.names, depth=2, step=int(js.step))
        ckpt.load_state_tree(ts, tree)
    assert tgen.step == 1 and tgen.opt_state["inner"]["count"] == 1
    y_null = np.random.default_rng(6).standard_normal((8, 32)).astype(np.float32)
    tstep = distill.make_dmd_train_step(
        tsched, _fn(gen), distill.make_cfg_real_fn(_fn(teacher), _t(y_null), 3.0), _fn(fake))
    m = tstep(tgen, tfake, {k: _t(v) for k, v in dmd_pair["batch"].items()}, None, {"y": _t(dmd_pair["y"])},
              draws=_draws_from_key(dmd_pair["keys"][1], 2, (2, 8, 8, 4)))
    for k, want in dmd_pair["jmetrics"][1].items():
        assert abs(float(m[k]) - want) <= 1e-5 * abs(want) + 1e-9, k
    _assert_params_close(tgen, pixart_params_to_torch(_np(jgen2.params), depth=2))


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_cfg_real_fn_matches_jax(scale):
    _, params, gen_fn = _jax_dit()
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    y = rng.standard_normal((2, 8, 32)).astype(np.float32)
    y_null = rng.standard_normal((1, 5, 32)).astype(np.float32)  # shorter than the token length: padded
    t = np.array([400, 37])
    raw = lambda z, t, **c: gen_fn(params, z, t, **c)  # noqa: E731
    want = jax_distill.make_cfg_real_fn(raw, jnp.asarray(y_null), scale)(jnp.asarray(z), jnp.asarray(t), y=jnp.asarray(y))
    traw = _fn(_torch_dit(params))
    real = distill.make_cfg_real_fn(traw, _t(y_null), scale)
    assert (real is traw) == (scale == 1.0)  # scale 1 short-circuits to the raw teacher
    with torch.no_grad():
        got = real(_t(z), _t(t), y=_t(y))
    assert _rel(got.numpy(), want) <= 1e-5


def test_swinir_and_reflow_losses_match_jax():
    jsched, tsched = jax_make_schedule("linear", 1000), make_schedule("linear", 1000)
    _, params, gen_fn = _jax_dit()
    model = _torch_dit(params)
    z0 = np.random.default_rng(1).standard_normal((2, 8, 8, 4), dtype=np.float32)
    y = np.zeros((2, 8, 32), np.float32)
    key = jax.random.key(4)
    t_rng, n_rng = jax.random.split(key)
    t, z_T = jax.random.randint(t_rng, (2,), 1, 1000), jax.random.normal(n_rng, z0.shape)
    want, _ = jax_distill.reflow_loss(jsched, gen_fn, params, jnp.asarray(z0), key, {"y": jnp.asarray(y)})
    got, metrics = distill.reflow_loss(tsched, _fn(model), _t(z0), cond={"y": _t(y)},
                                       t=_t(np.asarray(t)).long(), z_T=_t(np.asarray(z_T)))
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * float(want) and "reflow_mse" in metrics
    one = distill.reflow_sample_1step(tsched, _fn(model), _t(z0), {"y": _t(y)})
    want1 = jax_distill.reflow_sample_1step(jsched, gen_fn, params, jnp.asarray(z0), {"y": jnp.asarray(y)})
    assert _rel(one.detach().numpy(), want1) <= 1e-5
    batch = {"lq": torch.ones(1, 4), "hq": torch.zeros(1, 4)}
    assert float(distill.swinir_loss(lambda x: 3 * x, batch)) == 9.0


# ---------------------------------------------------------------------------
# optimizers and schedules against optax


def _tree():
    rng = np.random.default_rng(0)
    # keys in sorted order: JAX flattens a dict by sorted key, the port takes a list
    return {"b": rng.standard_normal((8,)).astype(np.float32), "k": rng.standard_normal((2, 3, 4, 5)).astype(np.float32),
            "w": rng.standard_normal((6, 8)).astype(np.float32)}


def _grads_for(params, i):
    return {k: (0.1 * np.cos(v + i) * (3.0 if k == "k" else 1.0)).astype(np.float32) for k, v in params.items()}


OPTIMIZERS = {
    "adamw": dict(name="adamw", weight_decay=0.01),
    "adamw_lowmem": dict(name="adamw", weight_decay=0.01, moment_dtype="bf16"),
    "lion": dict(name="lion", weight_decay=0.01),
    "lion_bf16_momentum": dict(name="lion", moment_dtype="bf16"),
    "came": dict(name="came", weight_decay=0.01),
}


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("which", list(OPTIMIZERS))
def test_optimizer_matches_optax(which, clip):
    kw = dict(OPTIMIZERS[which])
    low = kw.pop("moment_dtype", None)
    jtx = jax_optim.build_optimizer(learning_rate=jax_optim.constant_with_warmup(1e-2, 2), grad_clip_norm=clip,
                                    moment_dtype=jnp.bfloat16 if low else None, **kw)
    ttx = optim.build_optimizer(learning_rate=optim.constant_with_warmup(1e-2, 2), grad_clip_norm=clip,
                                moment_dtype=torch.bfloat16 if low else None, **kw)
    params = _tree()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [_t(v.copy()) for v in params.values()]
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        g = _grads_for(params, i)
        upd, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update(tp, [_t(v) for v in g.values()], ts)
        # bf16 moments round at a boundary that a last-bit difference can cross: one bf16 step of the moment
        tol = 2e-4 if low else 1e-5
        for (name, want), got in zip(jp.items(), tp):
            assert _rel(got.numpy(), want) <= tol, (name, i)
    if low:
        moments = ts["inner"]["mu"] + ts["inner"].get("nu", [])
        assert all(m.dtype == torch.bfloat16 for m in moments)


SCHEDULES = {
    "constant_with_warmup": ((3e-4, 7), {}),
    "cosine_with_warmup": ((3e-4, 7, 50), {}),
    "cosine_decay_to_constant_with_warmup": ((3e-4, 7, 50), dict(final_ratio=0.1, decay_fraction=0.5)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    args, kw = SCHEDULES[name]
    want, got = getattr(jax_optim, name)(*args, **kw), getattr(optim, name)(*args, **kw)
    for step in (0, 1, 2, 6, 7, 20, 28, 29, 49, 50, 80):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-5, abs=1e-12), step  # f32 cos near pi
    assert optim.auto_scale_lr(1e-4, 64) == jax_optim.auto_scale_lr(1e-4, 64)
    assert optim.auto_scale_lr(1e-4, 64, rule="linear") == jax_optim.auto_scale_lr(1e-4, 64, rule="linear")


class _Leaf(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(_t(w).clone())


def test_grad_accum_steps_and_ema_advance_on_every_call_like_multisteps():
    """Between the k-th calls optax.MultiSteps emits no update, but the JAX
    TrainState still advances its step and EMA on every call."""
    w = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    kw = dict(learning_rate=1e-2, grad_clip_norm=1.0, grad_accum=2)
    js = JaxTrainState.create({"w": jnp.asarray(w)}, jax_optim.build_optimizer("adamw", **kw), ema=True, ema_rate=0.9)
    ts = TrainState.create(_Leaf(w), optim.build_optimizer("adamw", **kw), ema=True, ema_rate=0.9)
    for i in range(5):
        g = (np.sin(w * (i + 1)) * (i + 1)).astype(np.float32)
        before = ts.params[0].detach().clone()
        js = js.apply_gradients({"w": jnp.asarray(g)})
        ts.apply_gradients([_t(g)])
        assert ts.step == int(js.step) == i + 1
        assert torch.equal(before, ts.params[0].detach()) == (i % 2 == 0)  # an update on every second call only
        assert _rel(ts.params[0].detach().numpy(), js.params["w"]) <= 1e-6
        assert _rel(ts.ema_params[0].numpy(), js.ema_params["w"]) <= 1e-6
    assert ts.opt_state["gradient_step"] == 2 and ts.opt_state["mini_step"] == 1
    assert ts.opt_state["inner"]["count"] == 2


class _Tree(torch.nn.Module):
    """A module whose parameters are the arrays of a dict, in its key order."""

    def __init__(self, tree):
        super().__init__()
        self.p = torch.nn.ParameterDict({k: torch.nn.Parameter(_t(v).clone()) for k, v in tree.items()})


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("which", list(OPTIMIZERS))
def test_nan_guard_matches_jax_and_a_nan_step_keeps_every_bit(which, accum):
    """Finite, NaN, finite, finite gradients through both packages'
    ``nan_guard``: after every step params and EMA agree with JAX's (whose
    guard selects ``jnp.where(ok, new, old)`` over the whole state), and
    after the NaN step the port's params, moments, EMA, step and count are
    bit for bit what they were."""
    from instarevive_tpu.utils.debug import nan_guard as jax_nan_guard
    from instarevive_tpu_torch.utils import debug

    kw = dict(OPTIMIZERS[which])
    low = kw.pop("moment_dtype", None)
    common = dict(learning_rate=None, grad_clip_norm=0.5, grad_accum=accum)
    jtx = jax_optim.build_optimizer(**dict(common, learning_rate=jax_optim.constant_with_warmup(1e-2, 2)),
                                    moment_dtype=jnp.bfloat16 if low else None, **kw)
    ttx = optim.build_optimizer(**dict(common, learning_rate=optim.constant_with_warmup(1e-2, 2)),
                                moment_dtype=torch.bfloat16 if low else None, **kw)
    params = _tree()
    js = JaxTrainState.create({k: jnp.asarray(v) for k, v in params.items()}, jtx, ema=True)
    ts = TrainState.create(_Tree(params), ttx, ema=True)

    def snapshot():
        inner = ts.opt_state["inner"]
        tensors = [*ts.params, *ts.ema_params] + [t for v in inner.values() if isinstance(v, list) for t in v]
        tensors += [t for t in ts.opt_state.get("acc_grads", [])]
        return [t.clone() for t in tensors], int(ts.step), int(inner["count"])

    tol = 2e-4 if low else 1e-5
    for i, bad in enumerate((False, True, False, False)):
        g = _grads_for(params, i)
        if bad:
            g["k"][1, 2, 3, 4] = np.nan
        before = snapshot()
        metrics = {}
        js = jax_nan_guard(js.apply_gradients, js, {k: jnp.asarray(v) for k, v in g.items()})
        ok = debug.nan_guard(ts, [_t(v) for v in g.values()], metrics)
        assert ok.dtype == torch.bool and ok.ndim == 0 and bool(ok) != bad and float(metrics["grads_finite"]) == float(not bad)
        if bad:
            after = snapshot()
            assert after[1:] == before[1:] and all(torch.equal(a, b) for a, b in zip(after[0], before[0]))
        assert int(ts.step) == int(js.step)
        for name, got, ema in zip(ts.names, ts.params, ts.ema_params):
            key = name.split(".")[-1]
            assert _rel(got.detach().numpy(), js.params[key]) <= tol, (name, i)
            assert _rel(ema.numpy(), js.ema_params[key]) <= tol, (name, i)


def test_nan_guard_reads_no_flag_on_the_host(monkeypatch):
    """Nothing inside ``nan_guard`` turns a tensor into a Python value: with
    ``bool``, ``item``, ``float`` and ``int`` of a tensor raising, a finite
    and a NaN step both run (AdamW with clipping, warm-up and an EMA)."""
    from instarevive_tpu_torch.utils import debug

    params = _tree()
    ts = TrainState.create(_Tree(params), optim.build_optimizer("adamw", optim.constant_with_warmup(1e-2, 2)), ema=True)
    grads = [_t(v) for v in _grads_for(params, 0).values()]
    nan = [g.clone() for g in grads]
    nan[0][0] = float("nan")

    def refuse(*_):
        raise AssertionError("a flag was read on the host")

    for name in ("__bool__", "item", "__float__", "__int__", "__index__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    ok_good = debug.nan_guard(ts, grads)
    ok_bad = debug.nan_guard(ts, nan)
    monkeypatch.undo()
    assert bool(ok_good) and not bool(ok_bad) and int(ts.step) == 1


def test_optax_masked_moves_a_frozen_leaf_by_its_gradient_and_the_port_keeps_it():
    """The JAX trainer freezes the UNet's encoder with ``optax.masked``, which
    passes a masked-out leaf's raw gradient through as its update, so
    ``TrainState.apply_gradients`` adds it: the "frozen" leaf moves by +1 x its
    gradient. The port freezes by ``requires_grad``: the leaf is not in the
    optimizer and keeps its bits. On the trained leaf both agree."""
    jtx = optax.masked(jax_optim.build_optimizer("adamw", 1e-4, grad_clip_norm=10.0), {"a": True, "b": False})
    js = JaxTrainState.create({"a": jnp.ones(3), "b": jnp.ones(3)}, jtx, ema=False)
    js = js.apply_gradients({"a": jnp.full(3, 0.5), "b": jnp.full(3, 0.5)})
    np.testing.assert_array_equal(np.asarray(js.params["b"]), np.full(3, 1.5, np.float32))  # 1.0 + the raw gradient

    module = _Tree({"a": np.ones(3, np.float32), "b": np.ones(3, np.float32)})
    module.p["b"].requires_grad_(False)
    ts = TrainState.create(module, optim.build_optimizer("adamw", 1e-4, grad_clip_norm=10.0), ema=False)
    assert ts.names == ["p.a"]
    ts.apply_gradients([torch.full((3,), 0.5)])
    assert torch.equal(module.p["b"].detach(), torch.ones(3))
    assert _rel(module.p["a"].detach().numpy(), js.params["a"]) <= 1e-6


def test_train_state_ema_warmup_and_bf16_shadow():
    w = np.ones((4, 4), np.float32)
    js = JaxTrainState.create({"w": jnp.asarray(w)}, optax.sgd(0.1), ema=True, ema_dtype=jnp.bfloat16)

    class Sgd(optim.Optimizer):
        def init(self, params):
            return {}

        def update(self, params, grads, state):
            for p, g in zip(params, grads):
                p.sub_(0.1 * g)

    ts = TrainState.create(_Leaf(w), Sgd(), ema=True, ema_dtype=torch.bfloat16)
    assert ts.ema_params[0].dtype == torch.bfloat16
    for _ in range(3):
        js = js.apply_gradients({"w": jnp.ones((4, 4))})
        ts.apply_gradients([torch.ones(4, 4)])
    assert ts.ema_params[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.ema_params[0].float().numpy(), np.asarray(js.ema_params["w"], np.float32))
    assert ts.ema_state_dict().keys() == {"w"}


# ---------------------------------------------------------------------------
# learning, checkpoints


def _loop(cfg, lr, warmup, seed=0, batch=2, **opt):
    """Generator, fake score and teacher from one JAX init, with fresh states."""
    _, params, _ = _jax_dit(cfg, seed=seed, batch=batch)
    gen, fake, teacher = (_torch_dit(params, cfg) for _ in range(3))
    teacher.requires_grad_(False)

    def tx():
        return optim.build_optimizer("adamw", optim.constant_with_warmup(lr, warmup), grad_clip_norm=10.0, **opt)

    states = (TrainState.create(gen, tx(), ema=True, ema_dtype=opt.get("moment_dtype")),
              TrainState.create(fake, tx(), ema=False))
    step = distill.make_dmd_train_step(make_schedule("linear", 1000), _fn(gen), _fn(teacher), _fn(fake))
    return states, step, gen


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


def _state_tensors(states):
    out = []
    for s in states:
        tree = ckpt.state_to_tree(s)
        out += list(tree["params"].values()) + list((tree["ema"] or {}).values())
        out += [x for k in ("mu", "nu") for x in tree["opt_state"]["inner"].get(k, [])]
        out.append(torch.tensor([tree["step"], tree["opt_state"]["inner"]["count"]]))
    return out


@pytest.mark.parametrize("lowmem", [False, True], ids=["f32_state", "bf16_moments_and_ema"])
def test_kill_resume_bitwise(tmp_path, lowmem):
    """Save at step 5, restore into fresh states, continue to step 10:
    bitwise equal to an unbroken 10-step run (params, EMA, moments, the fake
    score's state, the generator's state)."""
    opt = dict(moment_dtype=torch.bfloat16) if lowmem else {}
    y = torch.zeros(2, 8, 16)
    batch = {k: _t(v) for k, v in _batch().items()}

    def run(states, step, generator, n):
        for _ in range(n):
            step(*states, batch, generator, {"y": y})

    ref_states, ref_step, _ = _loop(SMALL, 1e-3, 5, **opt)
    run(ref_states, ref_step, torch.Generator().manual_seed(7), 10)

    mid_states, mid_step, _ = _loop(SMALL, 1e-3, 5, **opt)
    generator = torch.Generator().manual_seed(7)
    run(mid_states, mid_step, generator, 5)
    path = str(tmp_path / "ck5")
    ckpt.save_train_state(path, mid_states, generator, 5)
    assert os.path.isfile(os.path.join(path, ckpt.FILE))

    new_states, new_step, _ = _loop(SMALL, 1e-3, 5, **opt)
    generator2 = torch.Generator().manual_seed(0)
    restored, step_i = ckpt.restore_train_state(path, new_states, generator2)
    assert step_i == 5 and restored[0] is new_states[0] and restored[0].step == 5
    if lowmem:
        assert restored[0].opt_state["inner"]["mu"][0].dtype == torch.bfloat16
        assert restored[0].ema_params[0].dtype == torch.bfloat16
    run(restored, new_step, generator2, 5)
    for a, b in zip(_state_tensors(ref_states), _state_tensors(restored)):
        assert torch.equal(a, b)


def test_restore_legacy_params_only(tmp_path):
    states, _, gen = _loop(SMALL, 1e-3, 5)
    mutated = {k: v + 1.0 for k, v in gen.state_dict().items()}
    ema = {n: torch.full_like(p, 2.0) for n, p in zip(states[0].names, states[0].params)}
    path = str(tmp_path / "legacy.pt")
    ckpt.save_checkpoint(path, {"params": mutated, "ema": ema})
    restored, step_i = ckpt.restore_train_state(path, states[:1], torch.Generator())
    assert step_i == 0 and restored[0].step == 0
    assert torch.equal(gen.state_dict()["blocks.0.attn.qkv.weight"], mutated["blocks.0.attn.qkv.weight"])
    assert all((e == 2.0).all() for e in restored[0].ema_params)
    with pytest.raises(ValueError):
        ckpt.save_checkpoint(str(tmp_path / "junk.pt"), {"other": 1})
        ckpt.restore_train_state(str(tmp_path / "junk.pt"), states[:1], None)


def test_load_null_embed(tmp_path):
    arr = np.random.default_rng(0).standard_normal((1, 6, 16)).astype(np.float32)
    np.save(tmp_path / "n.npy", arr)
    np.savez(tmp_path / "n.npz", arr)
    torch.save({"uncond": torch.from_numpy(arr)}, tmp_path / "n.pth")
    for name in ("n.npy", "n.npz", "n.pth"):
        got = ckpt.load_null_embed(str(tmp_path / name))
        assert got.shape == (6, 16) and got.dtype == np.float32
        np.testing.assert_array_equal(got, arr[0])


# ---------------------------------------------------------------------------
# gradient checkpointing, compute dtype


def _loss_and_grads(model, z, t, y, mask=None):
    out = model(z, t, y, y_mask=mask)
    return torch.autograd.grad(out.float().pow(2).mean(), list(model.parameters()))


def test_grad_checkpoint_changes_no_gradient():
    _, params, _ = _jax_dit()
    rng = np.random.default_rng(2)
    z, y = _t(rng.standard_normal((2, 8, 8, 4), dtype=np.float32)), _t(rng.standard_normal((2, 8, 32)).astype(np.float32))
    t = torch.tensor([400.0, 20.0])
    mask = _t(np.arange(8)[None] < np.array([[8], [3]]))
    plain = _loss_and_grads(_torch_dit(params), z, t, y, mask)
    remat_model = _torch_dit(params, grad_checkpoint=True)
    remat = _loss_and_grads(remat_model, z, t, y, mask)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    with torch.no_grad():  # no recompute machinery without grad
        assert torch.equal(remat_model(z, t, y), _torch_dit(params)(z, t, y))
    # remat_policy "dots" keeps the products' outputs and recomputes the rest: the same bits again
    dots = _loss_and_grads(_torch_dit(params, grad_checkpoint=True, remat_policy="dots"), z, t, y, mask)
    for a, b in zip(plain, dots):
        assert torch.equal(a, b)


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D products (``aten.mm``, ``aten.addmm``) dispatched under it."""

    def __init__(self):
        super().__init__()
        self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.products += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_dots_recomputes_no_product_in_the_backward():
    """The backward's products, counted at the dispatcher: under ``full`` the
    plain backward's plus one for every Linear of the blocks (their
    recomputed forward), under ``dots`` the plain backward's alone."""
    _, params, _ = _jax_dit()
    rng = np.random.default_rng(3)
    z, y = _t(rng.standard_normal((2, 8, 8, 4), dtype=np.float32)), _t(rng.standard_normal((2, 8, 32)).astype(np.float32))
    t = torch.tensor([400.0, 20.0])
    products = {}
    for policy in ("none", "full", "dots"):
        model = _torch_dit(params, **({} if policy == "none" else dict(grad_checkpoint=True, remat_policy=policy)))
        loss = model(z, t, y).pow(2).mean()
        with _CountProducts() as mode:
            torch.autograd.grad(loss, list(model.parameters()))
        products[policy] = mode.products
    linears = sum(isinstance(m, torch.nn.Linear) for m in model.blocks.modules())
    assert linears == 7 * DIT["depth"] and products["none"] > 0
    assert products["dots"] == products["none"] and products["full"] == products["none"] + linears


def test_dots_gradients_match_jax_grad():
    """A tiny DiT checkpointed under ``dots``: its parameter gradients against
    ``jax.grad`` through the JAX package's ``PixArt(grad_checkpoint=True,
    remat_policy="dots")``, within 1e-4 of the largest gradient."""
    _, params, _ = _jax_dit()
    rng = np.random.default_rng(4)
    z, y = rng.standard_normal((2, 8, 8, 4), dtype=np.float32), rng.standard_normal((2, 8, 32)).astype(np.float32)
    t = np.array([400.0, 20.0], np.float32)
    jdit = JaxPixArt(**DIT, grad_checkpoint=True, remat_policy="dots")
    want = jax.jit(jax.grad(lambda p: jnp.mean(jdit.apply({"params": p}, jnp.asarray(z), jnp.asarray(t),
                                                          jnp.asarray(y)) ** 2)))(params)
    want = pixart_params_to_torch(_np(want), depth=DIT["depth"])
    model = _torch_dit(params, grad_checkpoint=True, remat_policy="dots")
    grads = _loss_and_grads(model, _t(z), _t(t), _t(y))
    top = max(np.abs(w).max() for w in want.values())
    for (name, _), g in zip(model.named_parameters(), grads):
        assert np.abs(g.numpy() - want[name]).max() <= 1e-4 * top, name


def test_bf16_compute_from_f32_masters_leaves_f32_gradients():
    _, params, _ = _jax_dit()
    rng = np.random.default_rng(2)
    z, y = _t(rng.standard_normal((2, 8, 8, 4), dtype=np.float32)), _t(rng.standard_normal((2, 8, 32)).astype(np.float32))
    t = torch.tensor([400.0, 20.0])
    f32 = _torch_dit(params)
    ref = _loss_and_grads(f32, z, t, y)
    model = set_compute_dtype(_torch_dit(params), torch.bfloat16)
    assert model(z, t, y).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.state_dict().keys() == f32.state_dict().keys()
    grads = _loss_and_grads(model, z, t, y)
    top = max(g.abs().max() for g in ref)
    for p, g, r in zip(model.parameters(), grads, ref):
        assert g.dtype == torch.float32 and g.shape == p.shape
        assert (g - r).abs().max() <= 0.1 * top  # bf16 products, f32 masters: close to the f32 gradient
    # the same casts as weights cast once: bf16 weights computing in their own dtype
    cast = _torch_dit(params)
    from instarevive_tpu_torch.pipelines.build import cast_weights
    cast_weights(cast, torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(cast(z, t, y), model(z, t, y))
    set_compute_dtype(model, None)
    with torch.no_grad():
        assert torch.equal(model(z, t, y), f32(z, t, y))


# ---------------------------------------------------------------------------
# data


def _write_pngs(folder, n, size=40, seed=0):
    from PIL import Image
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size + 8, 3), dtype=np.uint8)).save(os.path.join(folder, f"{i:02d}.png"))
    return folder


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


def test_prefetch_loader_fast_forward_continues_the_stream():
    from instarevive_tpu_torch.data.dataset import PrefetchLoader

    def stream(loader, n):
        out = []
        while len(out) < n:
            for batch in loader:
                out.append(batch["i"].tolist())
                if len(out) == n:
                    break
        return out

    full = stream(PrefetchLoader(_Indices(10), 3, seed=4), 8)
    assert len({tuple(b) for b in full}) > 3  # shuffled, three batches an epoch
    for consumed in (2, 3, 7):
        resumed = PrefetchLoader(_Indices(10), 3, seed=4)
        resumed.fast_forward(consumed)
        assert stream(resumed, 8 - consumed) == full[consumed:], consumed
    with pytest.raises(ValueError):
        list(PrefetchLoader(_Indices(2), 3))


def test_image_folder_dataset_crops_and_file_list(tmp_path):
    from instarevive_tpu_torch.data.dataset import ImageFolderDataset, PairQueue, closest_bucket, parse_prompt_aspect

    folder = _write_pngs(str(tmp_path / "hq"), 3)
    ds = ImageFolderDataset(folder, out_size=32, crop_type="random", seed=1)
    assert len(ds) == 3 and ds[0]["hq"].shape == (32, 32, 3) and ds[0]["hq"].dtype == np.uint8
    big = ImageFolderDataset(folder, out_size=64, crop_type="center", use_hflip=False)
    assert big[1]["hq"].shape == (64, 64, 3)  # short side 40 is resized up first
    listing = tmp_path / "files.txt"
    listing.write_text("\n".join(ds.files[:2]) + "\n")
    assert len(ImageFolderDataset(str(listing), out_size=32)) == 2
    q = PairQueue(4)
    lq, hq = np.zeros((2, 1)), np.ones((2, 1))
    assert q(lq, hq)[0] is lq and q(lq, hq)[1] is hq and q(lq + 5, hq)[0].shape == (2, 1)
    assert closest_bucket(1.3) == (576, 432)
    assert parse_prompt_aspect("a cat --ar 4:3") == ("a cat", 4 / 3)


def test_dmd_pair_and_internal_datasets_on_written_files(tmp_path):
    import json

    from instarevive_tpu_torch.data.dataset import AspectRatioBatchSampler, PrefetchLoader
    from instarevive_tpu_torch.data.internal import DMDPairDataset, InternalFeatureDataset

    rng = np.random.default_rng(0)
    dirs = {k: tmp_path / k for k in ("noise", "latent", "t5")}
    for d in dirs.values():
        d.mkdir()
    for i in range(4):
        np.save(dirs["noise"] / f"s{i}.npy", rng.standard_normal((8, 8, 4)).astype(np.float32))
        if i < 3:  # s3 has no latent: dropped
            np.savez(dirs["latent"] / f"s{i}.npz", latent=rng.standard_normal((8, 8, 4)).astype(np.float32))
            np.savez(dirs["t5"] / f"s{i}.npz", caption_feature=rng.standard_normal((1, 5, 16)).astype(np.float32))
    ds = DMDPairDataset(str(dirs["noise"]), str(dirs["latent"]), t5_dir=str(dirs["t5"]))
    assert len(ds) == 3 and ds.names == ["s0", "s1", "s2"]
    item = ds[1]
    assert item["noise"].shape == item["latent"].shape == (8, 8, 4) and item["txt_fea"].shape == (1, 5, 16)
    batch = next(iter(PrefetchLoader(ds, 3, shuffle=False)))
    assert batch["noise"].shape == (3, 8, 8, 4) and batch["txt_fea"].shape == (3, 1, 5, 16)

    manifest = tmp_path / "data_info.json"
    manifest.write_text(json.dumps([{"vae_feat": "latent/s0.npz", "t5_feat": "t5/s0.npz", "ratio": 0.5},
                                    {"vae_feat": "latent/s1.npz", "ratio": 1.0}]))
    feats = InternalFeatureDataset(str(manifest), root=str(tmp_path))
    assert feats.ratios == [0.5, 1.0] and feats[0]["latent"].shape == (8, 8, 4) and "txt_fea" not in feats[1]
    batches = list(AspectRatioBatchSampler([0.5, 0.52, 1.0, 1.0, 1.02], 2))
    assert sorted(len(c) for _, c in batches) == [2, 2] and {r for r, _ in batches} == {0.5, 1.0}


# ---------------------------------------------------------------------------
# utils


def test_logging_and_debug_helpers(tmp_path):
    from instarevive_tpu_torch.utils import debug
    from instarevive_tpu_torch.utils.logging import LogBuffer, close_logger, get_root_logger, log_images_panel

    buf = LogBuffer(window=2)
    for v in (1.0, 2.0, 4.0):
        buf.update({"loss": v})
    assert buf.average() == {"loss": 3.0}
    buf.clear()
    assert buf.average() == {}
    log = str(tmp_path / "run" / "train.log")
    logger = get_root_logger(log, name="torch_train_test")
    logger.info("hello")
    close_logger("torch_train_test")
    assert "hello" in open(log).read()
    get_root_logger(log, name="torch_train_test")  # the stale log is renamed, not appended to
    close_logger("torch_train_test")
    assert len(os.listdir(tmp_path / "run")) == 2
    assert log_images_panel(np.zeros((1, 4, 4, 3)), np.ones((1, 4, 4, 3))).shape == (1, 4, 8, 3)

    good, bad = {"a": torch.ones(3), "b": torch.zeros(2)}, {"a": torch.ones(3), "b": torch.tensor([1.0, float("nan")])}
    assert debug.first_nonfinite_paths(good) == [] and debug.first_nonfinite_paths(bad) == ["b"]
    assert bool(debug.all_finite(good.values())) and not bool(debug.all_finite(bad.values()))
    state = TrainState.create(_Leaf(np.ones((2, 2), np.float32)), optim.build_optimizer("adamw", 0.1), ema=True)
    metrics = {}
    assert not debug.nan_guard(state, [torch.full((2, 2), float("inf"))], metrics)  # the flag, a 0-dim bool tensor
    assert state.step == 0 and (state.params[0] == 1).all() and float(metrics["grads_finite"]) == 0.0
    assert debug.nan_guard(state, [torch.ones(2, 2)]) and state.step == 1 and (state.params[0] < 1).all()
    timer = debug.SimpleTimer(10, log_interval=2, initial=4)
    assert timer.update() is None and "[6/10]" in timer.update()


# ---------------------------------------------------------------------------
# the launcher


def test_launcher_trains_writes_final_and_resumes(tmp_path):
    from instarevive_tpu_torch.train import launcher

    data = _write_pngs(str(tmp_path / "hq"), 4, size=72)
    out = str(tmp_path / "run")
    common = ["--device", "cpu", "--config", os.path.join(REPO, "configs", "tiny.yaml"), "--task", "dmd",
              "--data", data, "--out", out, "--batch_size", "2", "--crop_size", "64", "--warmup", "1"]
    run = launcher.main(common + ["--steps", "2"])
    assert (run.start_step, run.end_step, len(run.history)) == (0, 2, 2)
    assert all(math.isfinite(v) for m in run.history for v in m.values())
    assert set(run.history[0]) == {"regression", "dm", "loss", "fake_score"}
    assert os.path.isfile(os.path.join(out, "final", ckpt.FILE)) and os.path.isfile(os.path.join(out, "train.log"))
    gen_state, fake_state = run.task.states
    assert gen_state.step == fake_state.step == 2 and gen_state.ema_params is not None and fake_state.ema_params is None
    assert not any(p.requires_grad for p in run.task.teacher.parameters())
    moved = {n: not torch.equal(p, t) for (n, p), t in zip(run.task.gen.named_parameters(), run.task.teacher.parameters())}
    # the caption is all zeros, so the caption projection's first weight has no gradient and stays
    assert moved["blocks.0.attn.qkv.weight"] and moved["final_layer.linear.bias"] and sum(moved.values()) > len(moved) // 2
    assert any(not torch.equal(p, t) for p, t in zip(run.task.fake.parameters(), run.task.teacher.parameters()))

    again = launcher.main(common + ["--steps", "3", "--resume", os.path.join(out, "final"), "--checkpointing_steps", "3"])
    assert (again.start_step, again.end_step, len(again.history)) == (2, 3, 1)
    assert os.path.isfile(os.path.join(out, "step_3", ckpt.FILE))  # and no second save as 'final'
    assert again.task.states[0].step == 3

    # every task the flags name has its trainer (cldm and reflow: tests/test_torch_cldm.py)
    assert set(launcher.TASKS) == {"dmd", "swinir", "cldm", "reflow"} and launcher.TASKS["reflow"] is launcher.CLDMTask
    # the degradation ran on every batch: its generators moved, and its draws imply the filter2d calls
    assert again.task.degrade.kind == "realesrgan" and 2 <= again.task.degrade.filter_calls <= 3
    assert not torch.equal(again.task.degrade.gens.host.get_state(), torch.Generator().manual_seed(0).get_state())


def test_launcher_saves_an_emergency_checkpoint_when_a_step_fails(tmp_path, monkeypatch):
    from instarevive_tpu_torch.train import launcher

    data = _write_pngs(str(tmp_path / "hq"), 4, size=72)
    out = str(tmp_path / "run")
    real, calls = launcher.DMDTask.run_step, []

    def failing(self, batch):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return real(self, batch)

    monkeypatch.setattr(launcher.DMDTask, "run_step", failing)
    with pytest.raises(RuntimeError, match="boom"):
        launcher.main(["--device", "cpu", "--config", os.path.join(REPO, "configs", "tiny.yaml"), "--task", "dmd",
                       "--data", data, "--out", out, "--batch_size", "2", "--crop_size", "64", "--steps", "3"])
    saved = ckpt.load_checkpoint(os.path.join(out, "crash_step_1"))
    assert saved["step_i"] == 1 and saved["states"][0]["step"] == 1
    assert set(saved["rng"]) == {"step", "degrade_host", "degrade_device"}
    assert not os.path.exists(os.path.join(out, "final"))


def test_launcher_module_entry_point_and_paired_loader(tmp_path):
    """``python -m instarevive_tpu_torch.train`` as a subprocess, with paired
    noise/latent files, caption features and bf16 low-memory state."""
    import subprocess
    import sys

    data = _write_pngs(str(tmp_path / "hq"), 2, size=72)
    rng = np.random.default_rng(0)
    for name in ("noise", "latent", "t5"):
        (tmp_path / name).mkdir()
    for i in range(2):
        np.save(tmp_path / "noise" / f"{i}.npy", rng.standard_normal((8, 8, 4)).astype(np.float32))
        np.save(tmp_path / "latent" / f"{i}.npy", rng.standard_normal((8, 8, 4)).astype(np.float32))
        np.savez(tmp_path / "t5" / f"{i}.npz", caption_feature=rng.standard_normal((1, 5, 64)).astype(np.float32))
    out = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "instarevive_tpu_torch.train", "--device", "cpu", "--task", "dmd",
           "--config", os.path.join(REPO, "configs", "tiny.yaml"), "--data", data, "--out", out,
           "--batch_size", "2", "--crop_size", "64", "--steps", "2", "--bf16", "--lowmem", "--grad_accum", "2",
           "--dmd_noise_dir", str(tmp_path / "noise"), "--dmd_latent_dir", str(tmp_path / "latent"),
           "--dmd_t5_dir", str(tmp_path / "t5")]
    done = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    saved = ckpt.load_checkpoint(os.path.join(out, "final"))
    assert saved["step_i"] == 2 and len(saved["states"]) == 2
    gen = saved["states"][0]
    assert gen["opt_state"]["inner"]["mu"][0].dtype == torch.bfloat16 and gen["opt_state"]["gradient_step"] == 1
    assert next(iter(gen["ema"].values())).dtype == torch.bfloat16
    assert gen["params"]["blocks.0.attn.qkv.weight"].dtype == torch.float32  # f32 masters under --bf16


# ---------------------------------------------------------------------------
# --task swinir


def _tiny():
    from instarevive_tpu_torch.config import load_config

    return load_config(os.path.join(REPO, "configs", "tiny.yaml"))


def _swinir_args(extra=()):
    from instarevive_tpu_torch.train import launcher

    return launcher.parse_args(["--device", "cpu", "--task", "swinir", "--data", "-", "--out", "-", "--batch_size", "2",
                                "--crop_size", "128", "--lr", "1e-4", "--warmup", "10", *extra])


def _pair(seed=0, size=128):
    """A clean batch in [-1, 1] as the degradation hands it on, and a degraded partner."""
    rng = np.random.default_rng(seed)
    hq01 = np.round(rng.random((2, size, size, 3), dtype=np.float32) * 255) / 255
    lq = np.clip(hq01 + 0.1 * rng.standard_normal(hq01.shape).astype(np.float32), 0, 1)
    return {"hq": (hq01 * 2.0 - 1.0).astype(np.float32), "lq": lq.astype(np.float32)}


@pytest.fixture(scope="module")
def swinir_pair():
    """Two steps of the JAX SwinIR trainer's step (``train.py``: the loss on
    ``{(hq + 1) / 2, lq}``, AdamW with clipping, EMA) and the same two steps of
    the port's ``SwinIRTask`` from the same state, carried across with
    ``swinir_train_state_from_jax``; 128 x 128 crops, so shifted windows and
    their masks take part. The gradients of step one are kept."""
    from instarevive_tpu.pipelines.build import build_pipeline as jax_build_pipeline
    from instarevive_tpu_torch.train import launcher

    cfg = _tiny()
    jsw = jax_build_pipeline(cfg).swinir
    params = jax.jit(jsw.init)(jax.random.key(2), jnp.zeros((1, 64, 64, 3)))["params"]
    # the table starts at trunc_normal(0.02): scale it up so that the bias matters to the loss
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 20.0 if "relative_position_bias_table" in jax.tree_util.keystr(path) else x, params)
    datas = [_pair(0), _pair(1)]
    jstate = JaxTrainState.create(params, jax_optim.build_optimizer(
        "adamw", jax_optim.constant_with_warmup(1e-4, 10), grad_clip_norm=10.0), ema=True)

    def jstep(state, data):
        # op by op, not under jit: XLA's fused CPU code moves these gradients by 1e-3 of their size against an
        # f64 reference, where op-by-op JAX and the port both stay within 4e-6 of it
        batch = {"hq": (data["hq"] + 1.0) / 2.0, "lq": data["lq"]}
        loss, grads = jax.value_and_grad(lambda p: jax_distill.swinir_loss(jsw, p, batch))(state.params)
        return state.apply_gradients(grads), loss, grads

    kw = dict(depths=tuple(cfg["swinir"]["depths"]))
    task = launcher.SwinIRTask(_swinir_args(), cfg, torch.device("cpu"))
    (tstate,) = task.states
    zeros = jax.tree_util.tree_map(np.zeros_like, _np(params))
    ckpt.load_state_tree(tstate, swinir_train_state_from_jax(_np(params), _np(params), zeros, zeros, 0, tstate.names, **kw))

    out = dict(jloss=[], tloss=[], jstates=[], kw=kw, task=task, params=params)
    for i, data in enumerate(datas):
        jstate, loss, grads = jstep(jstate, {k: jnp.asarray(v) for k, v in data.items()})
        out["jloss"].append(float(loss))
        out["jstates"].append(jstate)
        kept = []
        metrics = task.train_step({k: _t(v) for k, v in data.items()}, keep_grads=kept)
        out["tloss"].append(float(metrics["loss"]))
        assert float(metrics["grads_finite"]) == 1.0
        if i == 0:
            out["jgrads"], out["tgrads"] = grads, _named(tstate, kept)
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_swinir_step_loss_matches_jax(swinir_pair, step):
    want, got = swinir_pair["jloss"][step], swinir_pair["tloss"][step]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_swinir_step_gradients_match_jax_bias_table_included(swinir_pair):
    """Every parameter's gradient against ``jax.grad`` of ``swinir_loss``, to
    1e-4 of that gradient's own largest magnitude."""
    want = swinir_params_to_torch(_np(swinir_pair["jgrads"]), **swinir_pair["kw"])
    got = swinir_pair["tgrads"]
    assert set(got) == set(want)
    tables = [n for n in got if n.endswith("relative_position_bias_table")]
    assert len(tables) == 4
    for name, g in got.items():
        top = np.abs(want[name]).max()
        assert top > 0 and np.abs(g.numpy() - want[name]).max() <= 1e-4 * top, name
    assert all(float(got[n].abs().max()) > 0 for n in tables)


def test_swinir_params_moments_and_ema_after_two_steps_match_jax(swinir_pair):
    jstate, (tstate,) = swinir_pair["jstates"][1], swinir_pair["task"].states
    kw = swinir_pair["kw"]
    adam = _adam_state(jstate.opt_state)
    assert int(adam.count) == tstate.opt_state["inner"]["count"] == 2 and int(jstate.step) == tstate.step == 2
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want = swinir_params_to_torch(_np(tree), **kw)
        for name, got in _named(tstate, tstate.opt_state["inner"][key]).items():
            # step two's gradient is taken at parameters that already differ between the packages wherever
            # Adam stepped either way on a rounding-noise gradient in step one; measured 2.7e-4 (mu), 1e-3 and 2e-3
            assert _rel(got.numpy(), want[name]) <= (1e-3 if key == "mu" else 2e-3), (key, name)
    _assert_params_close(tstate, swinir_params_to_torch(_np(jstate.params), **kw))
    _assert_params_close(tstate, swinir_params_to_torch(_np(jstate.ema_params), **kw), tstate.ema_params)
    first = swinir_params_to_torch(_np(swinir_pair["params"]), **kw)
    assert all(not np.array_equal(p.detach().numpy(), first[n]) for n, p in zip(tstate.names, tstate.params))


def test_swinir_task_checkpoint_resume_takes_the_same_next_step(tmp_path):
    """Save after two steps, restore into a fresh task (states and the
    degradation's generators), take step three from the same loader batch:
    bitwise the step an unbroken task takes."""
    from instarevive_tpu_torch.train import launcher

    cfg, device = _tiny(), torch.device("cpu")
    rng = np.random.default_rng(0)
    batches = [{"hq": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)} for _ in range(3)]
    args = _swinir_args(["--seed", "3"])
    task = launcher.SwinIRTask(args, cfg, device)
    for batch in batches[:2]:
        task.run_step(batch)
    path = str(tmp_path / "ck2")
    ckpt.save_train_state(path, task.states, task.generators(), 2)
    want = task.run_step(batches[2])

    fresh = launcher.SwinIRTask(args, cfg, device)
    fresh.states, step_i = ckpt.restore_train_state(path, fresh.states, fresh.generators())
    assert step_i == 2 and fresh.states[0].step == 2
    got = fresh.run_step(batches[2])
    assert float(got["loss"]) == float(want["loss"])
    for a, b in zip(_state_tensors(task.states), _state_tensors(fresh.states)):
        assert torch.equal(a, b)
    # without the generators' states the degradation draws anew and the step differs
    other = launcher.SwinIRTask(args, cfg, device)
    other.states, _ = ckpt.restore_train_state(path, other.states, None)
    assert float(other.run_step(batches[2])["loss"]) != float(want["loss"])


def test_run_step_degrades_the_batch_and_trains_on_the_pair(monkeypatch):
    """``run_step`` hands ``train_step`` exactly what the degradation program
    makes of the loader batch under the same draws."""
    from instarevive_tpu_torch.data.realesrgan import degrade_batch, draw_degradation
    from instarevive_tpu_torch.ops.degradation import make_generators
    from instarevive_tpu_torch.train import launcher

    task = launcher.SwinIRTask(_swinir_args(), _tiny(), torch.device("cpu"))
    batch = {"hq": np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)}
    draws = draw_degradation(torch.Generator().manual_seed(8), task.degrade.cfg, 2)
    seen = {}
    monkeypatch.setattr(task, "train_step", lambda data: seen.update(data) or {})
    task.run_step(batch, draws=draws)
    want = degrade_batch(make_generators(0, "cpu"), _t(batch["hq"]).float() / 255.0, task.degrade.cfg, draws=draws)
    assert torch.equal(seen["lq"], want["lq"]) and torch.equal(seen["hq"], want["hq"])
    assert task.degrade.filter_calls == 2 + int(draws.blur2)


def test_launcher_swinir_trains_resumes_and_takes_the_degradation_flag(tmp_path):
    from instarevive_tpu_torch.train import launcher

    data = _write_pngs(str(tmp_path / "hq"), 4, size=72)
    common = ["--device", "cpu", "--config", os.path.join(REPO, "configs", "tiny.yaml"), "--task", "swinir",
              "--data", data, "--batch_size", "2", "--crop_size", "64", "--warmup", "1", "--lr", "1e-4"]
    out = str(tmp_path / "run")
    run = launcher.main(common + ["--out", out, "--steps", "2"])
    assert (run.start_step, run.end_step, len(run.history)) == (0, 2, 2)
    assert all(set(m) == {"loss", "grads_finite"} and math.isfinite(m["loss"]) and m["grads_finite"] == 1.0 for m in run.history)
    (state,) = run.task.states
    assert isinstance(run.task, launcher.SwinIRTask) and state.step == 2 and state.ema_params is not None
    assert not torch.equal(state.ema_params[0], state.params[0].detach())
    assert run.task.pipe.vae is None and run.task.pipe.dit is None  # only the model it trains is built
    saved = ckpt.load_checkpoint(os.path.join(out, "final"))
    assert saved["step_i"] == 2 and len(saved["states"]) == 1 and set(saved["rng"]) == {"degrade_host", "degrade_device"}
    host_state = run.task.degrade.gens.host.get_state()

    again = launcher.main(common + ["--out", out, "--steps", "3", "--resume", os.path.join(out, "final")])
    assert (again.start_step, again.end_step, len(again.history)) == (2, 3, 1) and again.task.states[0].step == 3
    assert torch.equal(saved["rng"]["degrade_host"], host_state)  # the resumed run started from these draws

    # the other program: one 41-tap blur a batch, another pair, another loss
    cf = launcher.main(common + ["--out", str(tmp_path / "cf"), "--steps", "2", "--degradation", "codeformer", "--bf16"])
    assert cf.task.degrade.kind == "codeformer" and cf.task.degrade.filter_calls == 2
    assert cf.history[0]["loss"] != run.history[0]["loss"] and math.isfinite(cf.history[1]["loss"])
    assert all(p.dtype == torch.float32 for p in cf.task.states[0].params)  # f32 masters under --bf16


def test_window_attention_function_backward_is_the_plain_version_gradient(monkeypatch):
    """The ``autograd.Function`` that wraps the kernel on the card, with its
    launch replaced by the plain forward: its recompute backward gives
    exactly autograd's gradients through the plain version, for qkv and for
    the bias, shifted with its mask and unshifted without, in f32 and with a
    bf16 qkv; and ``gradcheck`` of the qkv gradient (the plain version
    computes in f32 whatever it is given, so with a coarse step)."""
    from instarevive_tpu_torch.ops import swin_attention as sw
    from instarevive_tpu_torch.ops import window as W

    calls = []

    def launch(qkv, bias, mask, heads, window, scale, shift):
        calls.append(shift)
        with torch.no_grad():
            return sw.swin_window_attention_plain(qkv, bias, mask, heads, window, scale, shift)

    monkeypatch.setattr(sw, "_launch", launch)
    gen = torch.Generator().manual_seed(0)
    heads, win, hd = 2, 8, 4
    mask = torch.from_numpy(W.shift_attn_mask(16, 24, win, 4))
    for dtype, shift, m in ((torch.float32, 4, mask), (torch.float32, 0, None), (torch.bfloat16, 4, mask)):
        qkv = torch.randn(2, 16, 24, 3 * heads * hd, generator=gen).to(dtype).requires_grad_(True)
        bias = torch.randn(heads, 64, 64, generator=gen).requires_grad_(True)
        grad = torch.randn(2, 16, 24, heads * hd, generator=gen).to(dtype)
        out = sw._SwinWindowAttention.apply(qkv, bias, m, heads, win, hd**-0.5, shift)
        got = torch.autograd.grad(out, (qkv, bias), grad)
        ref = sw.swin_window_attention_plain(qkv, bias, m, heads, win, hd**-0.5, shift)
        want = torch.autograd.grad(ref, (qkv, bias), grad)
        assert torch.equal(out, ref) and got[0].dtype == dtype and got[1].dtype == torch.float32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and float(got[1].abs().max()) > 0
        (only_q,) = torch.autograd.grad(sw._SwinWindowAttention.apply(qkv, bias.detach(), m, heads, win, hd**-0.5, shift),
                                        qkv, grad)
        assert torch.equal(only_q, want[0])
    assert calls == [4, 4, 0, 0, 4, 4]  # one launch a forward, none in a backward
    small = torch.randn(1, 8, 8, 3 * 2, dtype=torch.float64, generator=gen, requires_grad=True)
    bias = torch.randn(1, 64, 64, generator=gen)
    assert torch.autograd.gradcheck(lambda q: sw._SwinWindowAttention.apply(q, bias, None, 1, win, 2**-0.5, 0), (small,),
                                    eps=1e-3, atol=1e-3, rtol=1e-2)


def test_upsample_function_backward_is_the_two_by_two_sum(monkeypatch):
    from instarevive_tpu_torch.ops import norm_kernels as nk

    monkeypatch.setattr(nk, "_launch_upsample2x", lambda x: nk.upsample2x_nearest_plain(x.detach()))
    x = torch.randn(2, 3, 4, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(1), requires_grad=True)
    assert torch.autograd.gradcheck(nk._Upsample2x.apply, (x,), eps=1e-6, atol=1e-8)
    grad = torch.randn(2, 6, 8, 5, generator=torch.Generator().manual_seed(2)).bfloat16()
    leaf = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(3), requires_grad=True)
    (want,) = torch.autograd.grad(nk.upsample2x_nearest_plain(leaf), leaf, grad.float())  # autograd through the plain version
    got = nk.upsample2x_backward(grad)  # summed in f32, rounded once to the gradient's dtype
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.bfloat16())


def test_bias_is_gathered_inside_autograd_only_while_the_table_takes_a_gradient():
    from instarevive_tpu_torch.models.swinir import WindowAttention

    attn = WindowAttention(12, 8, 2)
    torch.nn.init.normal_(attn.relative_position_bias_table, std=0.5)
    live = attn.bias()
    assert live.requires_grad and "_derived" not in attn.__dict__
    live.sum().backward()
    assert float(attn.relative_position_bias_table.grad.abs().sum()) > 0
    with torch.no_grad():
        packed = attn.bias()
        assert not packed.requires_grad and attn.bias() is packed and torch.equal(packed, live.detach())
        attn.relative_position_bias_table.mul_(2.0)  # an optimizer step: the pack follows the table's version
        assert torch.equal(attn.bias(), live.detach() * 2.0)
    attn.requires_grad_(False)
    assert attn.bias() is attn.bias() and not attn.bias().requires_grad
