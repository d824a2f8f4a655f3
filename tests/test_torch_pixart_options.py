"""The DiT's options (KV compression, qk-norm, windowed blocks,
micro-conditioning) against the JAX package's ``PixArt`` on the CPU.

Tiny widths (hidden 64, 4 heads, depth 2, 8 caption channels), f32, the JAX
params carried over by ``convert/from_jax``, atol 1e-4 as in
``tests/test_torch_models.py``. The latent is 10 x 12, a 5 x 6 token grid:
every-r-th-token compression keeps 3 x 3 of it and a 4-token window pads it
to 8 x 8. The ``conv`` compression cannot be built by the JAX package (its
``_downsample`` names a second ``sr`` and ``norm`` for v), so its attention
is held against a composition of flax's depthwise ``nn.Conv`` and
``nn.LayerNorm`` with one parameter set for k and v (the reference's
``AttentionKVCompress``) and the JAX package's ``attention``. Then, for the
slice as a whole, a ``uniform`` DiT through 4 DPM-Solver++(2M) steps against
the JAX package's sampler (the latents to 1e-5 of max(1, max|ref|), as
``tests/test_torch_sample.py`` holds them), and the seeded init of the new
leaves.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import flax.linen as fnn
import jax
import jax.numpy as jnp

from instarevive_tpu.diffusion import schedules as jschedules
from instarevive_tpu.diffusion.dpm_solver import dpm_solver_pp_2m as jax_dpm_solver_pp_2m
from instarevive_tpu.models.pixart import PixArt as JaxPixArt
from instarevive_tpu.ops.attention import attention as jax_attention
from instarevive_tpu_torch.convert.from_jax import state_dicts_from_jax
from instarevive_tpu_torch.diffusion import schedules as tschedules
from instarevive_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m
from instarevive_tpu_torch.models.pixart import PixArt, SelfAttention
from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params

ATOL = 1e-4
BASE = dict(input_size=12, patch_size=2, hidden_size=64, depth=2, num_heads=4, caption_channels=8,
            model_max_length=6)
LATENT = (2, 10, 12, 4)  # a 5 x 6 token grid
UNIFORM = dict(kv_compress_sampling="uniform", kv_compress_ratio=2, kv_compress_layers=[0])
OPTIONS = {
    "uniform": UNIFORM,
    "ave": dict(kv_compress_sampling="ave", kv_compress_ratio=2, kv_compress_layers=[1]),
    "qk_norm": dict(qk_norm=True),
    "window_padded_grid": dict(window_size=4, window_block_indexes=[1]),
    "micro_condition": dict(micro_condition=True),
    "micro_condition_data_info": dict(micro_condition=True),
    "all": dict(UNIFORM, qk_norm=True, window_size=4, window_block_indexes=[1], micro_condition=True),
}
DATA_INFO = {"img_hw": np.array([[80.0, 96.0], [64.0, 64.0]], np.float32),
             "aspect_ratio": np.array([[0.8], [1.0]], np.float32)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(LATENT).astype(np.float32)
    y = rng.standard_normal((2, BASE["model_max_length"], BASE["caption_channels"])).astype(np.float32)
    return z, np.array([400.0, 20.0], np.float32), y


def _pair(options, seed=0):
    """The JAX DiT with seeded params, and the port's with those params."""
    kw = dict(BASE, **options)
    jdit = JaxPixArt(**kw)
    z, t, y = _inputs()
    params = jax.jit(jdit.init)(jax.random.key(seed), jnp.asarray(z), jnp.asarray(t), jnp.asarray(y))["params"]
    dit = PixArt(**kw)
    dit.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in state_dicts_from_jax({"dit": params}, {"dit": kw})["dit"].items()})
    return jdit, params, dit


@pytest.mark.parametrize("case", list(OPTIONS))
def test_dit_option_matches_jax(case):
    jdit, params, dit = _pair(OPTIONS[case])
    z, t, y = _inputs(1)
    info = DATA_INFO if case == "micro_condition_data_info" else None
    ref = jdit.apply({"params": params}, jnp.asarray(z), jnp.asarray(t), jnp.asarray(y),
                     data_info=None if info is None else {k: jnp.asarray(v) for k, v in info.items()})
    with torch.no_grad():
        out = dit(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y),
                  data_info=None if info is None else {k: torch.from_numpy(v) for k, v in info.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if case == "micro_condition_data_info":  # the sizes given move the output off the latent-size default
        with torch.no_grad():
            assert not torch.allclose(out, dit(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y)))


class _SharedConvKV(fnn.Module):
    """``AttentionKVCompress`` with ``sampling='conv'``: one depthwise
    stride-r conv and one LayerNorm, applied to k and to v."""

    dim: int
    num_heads: int
    ratio: int
    qk_norm: bool

    @fnn.compact
    def __call__(self, x, hw):
        b, n, c = x.shape
        h, gh, gw = self.num_heads, *hw
        q, k, v = jnp.split(fnn.Dense(3 * c, name="qkv")(x), 3, axis=-1)
        if self.qk_norm:
            q = fnn.LayerNorm(epsilon=1e-5, name="q_norm")(q)
            k = fnn.LayerNorm(epsilon=1e-5, name="k_norm")(k)
        sr = fnn.Conv(c, (self.ratio, self.ratio), strides=(self.ratio, self.ratio), feature_group_count=c, name="sr")
        norm = fnn.LayerNorm(epsilon=1e-5, name="norm")
        k, v = (norm(sr(t.reshape(b, gh, gw, c))).reshape(b, -1, c) for t in (k, v))

        def heads(t):
            return jnp.transpose(t.reshape(b, -1, h, c // h), (0, 2, 1, 3))

        out = jax_attention(heads(q), heads(k), heads(v), scale=(c // h) ** -0.5)
        return fnn.Dense(c, name="proj")(jnp.transpose(out, (0, 2, 1, 3)).reshape(b, n, c))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_conv_kv_compression_matches_a_shared_sr(qk_norm):
    """On a 6 x 8 grid, which the ratio 2 divides (flax's SAME padding is
    then none, as the reference's unpadded conv)."""
    dim, heads, r, hw = 64, 4, 2, (6, 8)
    x = np.random.default_rng(2).standard_normal((2, hw[0] * hw[1], dim)).astype(np.float32)
    ref_mod = _SharedConvKV(dim, heads, r, qk_norm)
    p = ref_mod.init(jax.random.key(3), jnp.asarray(x), hw)["params"]
    rng = np.random.default_rng(4)  # norms away from (1, 0), so that both their parameters matter
    p = {name: {k: (jnp.asarray(v + 0.3 * rng.standard_normal(v.shape).astype(np.float32))
                    if name.endswith("norm") else v) for k, v in leaves.items()} for name, leaves in p.items()}
    ref = ref_mod.apply({"params": p}, jnp.asarray(x), hw)

    attn = SelfAttention(dim, heads, sampling="conv", sr_ratio=r, qk_norm=qk_norm)
    sd = {}
    for name, leaves in p.items():
        for leaf, value in leaves.items():
            value = np.asarray(value)
            key = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
            if leaf == "kernel":
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            sd[f"{name}.{key}"] = torch.from_numpy(np.array(value))
    attn.load_state_dict(sd)
    assert tuple(attn.sr.weight.shape) == (dim, 1, r, r)
    with torch.no_grad():
        out = attn(torch.from_numpy(x), hw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_conv_kv_compression_refuses_a_grid_the_ratio_does_not_divide():
    dit = PixArt(**BASE, kv_compress_sampling="conv", kv_compress_ratio=2, kv_compress_layers=[0])
    z, t, y = _inputs()
    with pytest.raises(ValueError, match="5x6"), torch.no_grad():
        dit(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y))


def test_kv_compressed_dit_samples_as_jax():
    """A ``uniform`` DiT through 4 DPM-Solver++(2M) steps, eps channels only."""
    jdit, params, dit = _pair(UNIFORM)
    z0, _, y = _inputs(5)
    sched = jschedules.make_schedule("linear", 1000)

    @jax.jit
    def jax_sample(params, x, y):
        def eps(x, t):
            return jdit.apply({"params": params}, x, t.astype(jnp.float32), y)[..., :4]

        return jax_dpm_solver_pp_2m(eps, sched, x, steps=4)

    ref = np.asarray(jax_sample(params, jnp.asarray(z0), jnp.asarray(y)))
    with torch.inference_mode():
        got = dpm_solver_pp_2m(lambda x, t: dit(x, t.float(), torch.from_numpy(y))[..., :4],
                               tschedules.make_schedule("linear", 1000), torch.from_numpy(z0), steps=4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_init_params_gives_the_new_leaves_flax_families():
    """lecun-normal (truncated at 2 sigma) for ``sr`` with fan-in r * r and
    for the size embedders' Linears, ones and zeros for the norms."""
    cfg = {"dit": dict(BASE, hidden_size=96, kv_compress_sampling="conv", kv_compress_ratio=4,
                       kv_compress_layers=[0, 1], qk_norm=True, micro_condition=True)}
    dit = init_params(build_pipeline(cfg, device="cpu", components=("dit",)), seed=0).dit
    sd = dit.state_dict()
    sr = torch.cat([sd[f"blocks.{i}.attn.sr.weight"].flatten() for i in range(2)])
    std = (1.0 / 16) ** 0.5
    assert sr.abs().max() <= 2 * std / 0.8796256610342398 + 1e-6 and abs(sr.std() / std - 1) < 0.1
    for name in ("norm", "q_norm", "k_norm"):
        assert torch.equal(sd[f"blocks.0.attn.{name}.weight"], torch.ones(96))
        assert torch.equal(sd[f"blocks.0.attn.{name}.bias"], torch.zeros(96))
    for emb, out in (("csize_embedder", 32), ("ar_embedder", 32)):
        w = sd[f"{emb}.mlp.0.weight"]
        assert w.shape == (out, 256) and abs(w.std() * 256**0.5 - 1) < 0.1
        assert torch.equal(sd[f"{emb}.mlp.2.bias"], torch.zeros(out))
