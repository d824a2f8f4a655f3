"""The port's SD UNet, ControlNet and ``controlled_unet_apply``
(instarevive_tpu_torch/models/unet.py), the new schedules, the
loss-second-moment sampler and LoRA against the JAX package on the CPU.

Weights are made once per module with numpy from a seed in the JAX package's
tree (its shapes from ``jax.eval_shape``, so no init is compiled), every leaf
non-zero (the zero-initialised layers too, so every path is exercised), and
carried to the port through ``convert/from_jax``. Inputs are numpy from a
seed. f32 on both sides; the models are held within ``ATOL`` as
``tests/test_torch_models.py`` holds the other models (the sums run in
another order), the schedules within 1e-7."""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from instarevive_tpu.diffusion import schedules as jax_schedules
from instarevive_tpu.diffusion import timestep_sampler as jax_ts
from instarevive_tpu.models.unet import UNetBackbone as JaxUNet
from instarevive_tpu.train import lora as jax_lora
from instarevive_tpu_torch.convert.from_jax import unet_kw, unet_params_to_torch
from instarevive_tpu_torch.diffusion import schedules, timestep_sampler
from instarevive_tpu_torch.models.unet import ZERO_INIT, UNetBackbone, controlled_unet_apply, zero_init_
from instarevive_tpu_torch.pipelines.build import init_params
from instarevive_tpu_torch.train import lora

ATOL = 1e-4
TINY = yaml.safe_load(open(__file__.rsplit("/", 2)[0] + "/configs/cldm_tiny.yaml"))


def _jax_cfg(section):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in section.items()}


def random_params(model, seed, *args):
    """A param tree of ``model``'s structure with numpy values: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (1.0 + 0.1 * x) if name == "scale" else 0.1 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def torch_model(params, section):
    model = UNetBackbone(**section)
    sd = unet_params_to_torch(params, **unet_kw(section))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return model


def _inputs(seed, b=2, hw=16, ctx_len=5, ctx_dim=32):
    rng = np.random.default_rng(seed)
    x, hint = (rng.standard_normal((b, hw, hw, 4)).astype(np.float32) for _ in range(2))
    t = np.array([3.0, 700.0][:b], np.float32)
    ctx = rng.standard_normal((b, ctx_len, ctx_dim)).astype(np.float32)
    return x, hint, t, ctx


@pytest.fixture(scope="module")
def tiny():
    """The cldm_tiny UNet and ControlNet in both packages, on one set of weights."""
    x, hint, t, ctx = _inputs(0)
    ju, jc = JaxUNet(**_jax_cfg(TINY["unet"])), JaxUNet(**_jax_cfg(TINY["controlnet"]))
    pu = random_params(ju, 1, x, t, ctx)
    pc = random_params(jc, 2, np.concatenate([x, hint], -1), t, ctx)
    return dict(ju=ju, jc=jc, pu=pu, pc=pc, tu=torch_model(pu, TINY["unet"]), tc=torch_model(pc, TINY["controlnet"]),
                inputs=(x, hint, t, ctx))


def test_unet_controlnet_and_controlled_unet_apply_match_jax(tiny):
    x, hint, t, ctx = tiny["inputs"]
    ju, jc = tiny["ju"], tiny["jc"]

    @jax.jit
    def jax_side(pu, pc):
        control = jc.apply({"params": pc}, jnp.concatenate([x, hint], -1), t, ctx)
        return control, ju.apply({"params": pu}, x, t, ctx, control=control), ju.apply({"params": pu}, x, t, ctx)

    control, want, want_plain = jax_side(tiny["pu"], tiny["pc"])
    tx, th, tt, tctx = (torch.from_numpy(a) for a in (x, hint, t, ctx))
    with torch.no_grad():
        got_control = UNetBackbone.forward(tiny["tc"], torch.cat([tx, th], -1), tt, tctx)
        got = controlled_unet_apply(tiny["tu"], tiny["tc"], tx, th, tt, tctx)
        got_plain = tiny["tu"](tx, tt, tctx)
    assert len(got_control) == len(control) == 5  # input conv, 3 blocks, the middle
    for a, b in zip(got_control, control):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_plain.numpy(), np.asarray(want_plain), atol=ATOL, rtol=0)
    assert np.abs(np.asarray(want) - np.asarray(want_plain)).max() > 1e-2  # the control residuals count


def test_unet_at_head_dim_64_matches_jax():
    """The head dim the card runs (64): model_channels 64, one level."""
    section = dict(in_channels=4, out_channels=4, model_channels=64, num_res_blocks=1, attention_ds=[1],
                   channel_mult=[1], num_head_channels=64, context_dim=64)
    x, _, t, ctx = _inputs(3, hw=8, ctx_len=4, ctx_dim=64)
    ju = JaxUNet(**_jax_cfg(section))
    params = random_params(ju, 4, x, t, ctx)
    want = jax.jit(lambda p: ju.apply({"params": p}, x, t, ctx))(params)
    model = torch_model(params, section)
    assert {blk.transformer_blocks[0].attn1.heads for blk in model.spatial_transformers()} == {1}
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, t, ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_zero_init_zeroes_what_the_reference_zeroes(tiny):
    """After the trainer's flax-style init (zero biases) the ControlNet's zero
    convolutions make a fresh ControlNet's residuals zero, and the UNet's
    last conv, every ResBlock's last conv and every proj_out are zero, as in
    the reference."""
    x, hint, t, ctx = (torch.from_numpy(a) for a in tiny["inputs"])
    cn = zero_init_(init_params(UNetBackbone(**TINY["controlnet"]), seed=0))
    with torch.no_grad():
        assert all(not r.any() for r in UNetBackbone.forward(cn, torch.cat([x, hint], -1), t, ctx))
    unet = zero_init_(init_params(UNetBackbone(**TINY["unet"]), seed=0))
    with torch.no_grad():
        assert not unet(x, t, ctx).any()
    zeroed = {n for n, p in unet.named_parameters() if n.endswith(".weight") and not p.any()}
    assert zeroed == {n for n, _ in unet.named_parameters() if n.endswith(ZERO_INIT)} and len(zeroed) == 1 + 7 + 8  # out.2, 7 proj_out, 8 ResBlocks


@pytest.mark.parametrize("name,kw", [("ldm_linear", {}), ("ldm_linear", dict(linear_start=0.001, linear_end=0.02)),
                                     ("squaredcos_cap_v2", {}), ("linear", dict(beta_start=0.0002, beta_end=0.03))])
def test_schedules_match_jax(name, kw):
    got, want = schedules.make_schedule(name, 1000, **kw), jax_schedules.make_schedule(name, 1000, **kw)
    for field in got._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), atol=1e-7, rtol=0,
                                   err_msg=field)


def test_loss_second_moment_sampler_matches_jax():
    """Weights (uniform until every timestep holds a full history, then
    sqrt(E[loss^2]) mixed with 0.001 uniform), the importance weights of a
    handed-in t, and ring-buffer updates with repeated timesteps."""
    T, H = 6, 3
    js, ts = jax_ts.loss_second_moment_init(T, H), timestep_sampler.loss_second_moment_init(T, H)
    rng = np.random.default_rng(0)
    for i in range(12):
        t = rng.integers(0, T, 4)
        t[1] = t[0]  # two losses at one timestep land in order
        losses = rng.random(4).astype(np.float32) + i
        js = jax_ts.loss_second_moment_update(js, jnp.asarray(t), jnp.asarray(losses))
        ts = timestep_sampler.loss_second_moment_update(ts, torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(ts["counts"].numpy(), np.asarray(js.counts))
        np.testing.assert_array_equal(ts["history"].numpy(), np.asarray(js.history))
        np.testing.assert_allclose(timestep_sampler.loss_second_moment_weights(ts).numpy(),
                                   np.asarray(jax_ts.loss_second_moment_weights(js)), rtol=1e-6)
    assert (ts["counts"] == H).all()  # warmed: the weights above were the importance weights at the end
    t = jnp.asarray([0, 5, 5])
    _, want = jax_ts.loss_second_moment_sample(jax.random.key(0), js, 3)
    p = jax_ts.loss_second_moment_weights(js)
    got_t, got_w = timestep_sampler.loss_second_moment_sample(None, ts, 3, t=torch.from_numpy(np.asarray(t)))
    np.testing.assert_allclose(got_w.numpy(), 1.0 / (T * np.asarray(p)[np.asarray(t)]), rtol=1e-6)
    drawn, w = timestep_sampler.loss_second_moment_sample(torch.Generator().manual_seed(0), ts, 500)
    assert drawn.shape == (500,) and w.shape == (500,) and 0 <= drawn.min() and drawn.max() < T
    t_u, w_u = timestep_sampler.uniform_sample_t(torch.Generator().manual_seed(0), 8, T, "cpu")
    assert t_u.max() < T and torch.equal(w_u, torch.ones(8))


def test_merge_lora_matches_jax(tiny):
    """JAX adapters (a random ``b``, so the delta is not zero) carried to the
    port's layout (down = a^T, up = b^T): the merged weights equal the JAX
    package's merged kernels through the exporter, the same layers are
    adapted, and the parameter counts agree."""
    pu = jax.tree_util.tree_map(jnp.asarray, tiny["pu"])
    jl = jax_lora.init_lora(jax.random.key(5), pu, rank=4)
    jl = jax.tree_util.tree_map(lambda x: x + 0.01 * jax.random.normal(jax.random.key(6), x.shape), jl)
    want = unet_params_to_torch(jax_lora.merge_lora(pu, jl), **unet_kw(TINY["unet"]))
    base = {k: torch.from_numpy(np.array(v)) for k, v in unet_params_to_torch(pu, **unet_kw(TINY["unet"])).items()}
    ours = lora.init_lora(torch.Generator().manual_seed(0), base, rank=4)

    flat = {}
    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict) and "a" in v and "b" in v:
                flat["/".join(path + [k])] = v
            elif isinstance(v, dict):
                walk(v, path + [k])
    walk(jl, [])
    # the exporter maps a flax Dense's path to its torch module: find each adapter's module by its kernel
    carried = {}
    for module in ours:
        w = base[module + ".weight"].numpy()
        match = [p for p, ad in flat.items() if ad["a"].shape == (w.shape[1], ad["a"].shape[1])
                 and np.array_equal(np.asarray(jax_lora._get(pu, p + "/kernel")).T, w)]
        assert len(match) == 1, module
        ad = flat.pop(match[0])
        carried[module] = {"down": torch.from_numpy(np.array(ad["a"]).T.copy()),
                           "up": torch.from_numpy(np.array(ad["b"]).T.copy())}
    assert not flat  # the same layers are adapted
    assert lora.count_lora_params(ours) == lora.count_lora_params(carried) == jax_lora.count_lora_params(jl)
    merged = lora.merge_lora(base, carried)
    for k in want:
        np.testing.assert_allclose(merged[k].numpy(), want[k], atol=1e-6, rtol=0, err_msg=k)
    assert all(not ad["up"].any() for ad in ours.values())  # a fresh adapter starts at a zero delta
