"""Port models against the JAX package's ``apply`` at the tiny widths of
configs/tiny.yaml, with the JAX params carried over by convert/from_jax
(f32 on the CPU, atol 1e-4), plus the committed DiT golden output."""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.config import load_config
from instarevive_tpu.models.pixart import PixArt as JaxPixArt
from instarevive_tpu.pipelines.build import build_pipeline as jax_build_pipeline
from instarevive_tpu_torch.convert.from_jax import state_dicts_from_jax
from instarevive_tpu_torch.models.pixart import PixArt
from instarevive_tpu_torch.pipelines.build import build_pipeline, load_state_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = load_config(os.path.join(REPO, "configs", "tiny.yaml"))
ATOL = 1e-4


@pytest.fixture(scope="module")
def pipes():
    """The JAX tiny pipeline with seeded params, and the port built from
    the same config with those params loaded."""
    jpipe = jax_build_pipeline(TINY)
    k1, k2, k3 = jax.random.split(jax.random.key(5), 3)
    y = jnp.zeros((1, TINY["dit"]["model_max_length"], TINY["dit"]["caption_channels"]))
    params = {
        "swinir": jax.jit(jpipe.swinir.init)(k1, jnp.zeros((1, 64, 64, 3)))["params"],
        "vae": jax.jit(jpipe.vae.init)(k2, jnp.zeros((1, 64, 64, 3)))["params"],
        "dit": jax.jit(jpipe.dit.init)(k3, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), y)["params"],
    }
    tpipe = load_state_dicts(build_pipeline(TINY, device="cpu"), **state_dicts_from_jax(params, TINY))
    return jpipe, params, tpipe


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("hw", [(128, 128), (100, 136)])
def test_swinir_matches_jax(pipes, hw):
    """128x128: 16x16 features, so shifted windows and their masks run;
    100x136: the reflect pad to a multiple of 64 and the crop back."""
    jpipe, params, tpipe = pipes
    x = _rand((2, *hw, 3), 0)
    ref = jax.jit(jpipe.swinir.apply)({"params": params["swinir"]}, jnp.asarray(x))
    with torch.no_grad():
        out = tpipe.swinir(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_swinir_runs_through_the_kernel_ops_on_nhwc_maps(pipes, monkeypatch):
    """The path the card takes, minus the kernels: every block's attention is
    one call of ``swin_window_attention`` (odd blocks with the shift and its
    mask, no roll, partition or reverse in the model) and every step of the
    upsampler one ``upsample2x_nearest``, here with their plain versions
    called by name; each is handed a contiguous NHWC tensor, and the packed
    bias is f32 and the same object from call to call. Held against the JAX
    SwinIR."""
    from instarevive_tpu_torch.models import swinir as swinir_mod
    from instarevive_tpu_torch.ops import window as window_mod
    from instarevive_tpu_torch.ops.norm_kernels import upsample2x_nearest_plain
    from instarevive_tpu_torch.ops.swin_attention import swin_window_attention_plain

    jpipe, params, tpipe = pipes
    calls = {"attn": [], "up": []}
    biases = {}

    def attn(qkv, bias, mask, heads, window, scale, shift=0):
        assert qkv.is_contiguous() and qkv.dim() == 4 and qkv.shape[-1] == 3 * TINY["swinir"]["embed_dim"]
        assert bias.dtype == torch.float32 and bias.shape == (heads, window**2, window**2) and bias.is_contiguous()
        assert (mask is None) == (shift == 0)
        if mask is not None:
            assert mask.shape == ((qkv.shape[1] // window) * (qkv.shape[2] // window), window**2, window**2)
        calls["attn"].append(shift)
        biases.setdefault((len(calls["attn"]) - 1) % n_blocks, []).append(bias)
        return swin_window_attention_plain(qkv, bias, mask, heads, window, scale, shift)

    def up(x):
        assert x.is_contiguous() and x.dim() == 4 and x.shape[-1] == 64, (x.shape, x.stride())
        calls["up"].append(tuple(x.shape[1:3]))
        return upsample2x_nearest_plain(x)

    def forbidden(*args, **kwargs):
        raise AssertionError("SwinIR's forward rolled or partitioned the map itself")

    n_blocks = sum(TINY["swinir"]["depths"])
    monkeypatch.setattr(swinir_mod, "swin_window_attention", attn)
    monkeypatch.setattr(swinir_mod, "upsample2x_nearest", up)
    x = _rand((2, 128, 192, 3), 7)
    ref = jax.jit(jpipe.swinir.apply)({"params": params["swinir"]}, jnp.asarray(x))
    with torch.no_grad():
        out = tpipe.swinir(torch.from_numpy(x))
        assert calls == {"attn": [0, 4] * (n_blocks // 2), "up": [(16, 24), (32, 48), (64, 96)]}
        tpipe.swinir(torch.from_numpy(x))  # the bias is packed once per module, not per call
        assert len(biases) == n_blocks and all(len(b) == 2 and b[0] is b[1] for b in biases.values())
        # with the op stubbed out, nothing of the model touches windows itself
        for name in ("window_partition", "window_reverse", "cyclic_shift", "cyclic_unshift"):
            monkeypatch.setattr(window_mod, name, forbidden)
        monkeypatch.setattr(swinir_mod, "swin_window_attention", lambda qkv, *a, **k: qkv[..., : qkv.shape[-1] // 3])
        tpipe.swinir(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("change", ["load_state_dict", "in_place", "dtype_round_trip", "inference_mode_reload"])
def test_swinir_packed_bias_follows_the_table(change):
    """The (heads, N, N) bias is gathered from the table once per module; a
    model that already ran must answer as a fresh one does once its weights
    are reloaded, written in place, or taken through another dtype and back.
    The pack is no state-dict key."""
    from instarevive_tpu_torch.models.swinir import SwinIR

    kw = dict(TINY["swinir"], depths=[2], num_heads=[6])

    def seeded(model, seed):
        gen = torch.Generator().manual_seed(seed)
        return {k: torch.randn(v.shape, generator=gen) * (0.5 if "bias_table" in k else 0.05)
                + (1.0 if "norm" in k and k.endswith("weight") else 0.0) for k, v in model.state_dict().items()}

    x = torch.from_numpy(_rand((1, 128, 128, 3), 8))
    with torch.inference_mode(change == "inference_mode_reload"):
        model = SwinIR(**kw).eval().requires_grad_(False)
        keys = list(model.state_dict())
        model.load_state_dict(seeded(model, 1))
        attn = model.layers[0].residual_group.blocks[1].attn
        with torch.no_grad():
            first = model(x)
        packed = attn.bias()
        assert attn.bias() is packed and packed.dtype == torch.float32 and packed.shape == (6, 64, 64)
        assert list(model.state_dict()) == keys and not any("_derived" in k or k.endswith(".bias_packed") for k in keys)

        new = seeded(model, 2)
        if change in ("load_state_dict", "inference_mode_reload"):
            model.load_state_dict(new)
        elif change == "in_place":
            with torch.no_grad():
                for k, p in model.state_dict().items():
                    p.copy_(new[k])
        else:
            model.load_state_dict(new)
            model.to(torch.bfloat16).to(torch.float32)
            assert not attn.__dict__.get("_derived")
            new = model.state_dict()
        fresh = SwinIR(**kw).eval().requires_grad_(False)
        fresh.load_state_dict(new)
        with torch.no_grad():
            out = model(x)
            want = fresh(x)
    assert attn.bias() is not packed
    assert not torch.allclose(out, first, atol=1e-3)
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_vae_encode_decode_match_jax(pipes):
    """The VAE matches the JAX VAE in f32; on the CPU, whose plain version
    reads no split-tf32 weight planes, no ResnetBlock conv packs them."""
    from instarevive_tpu_torch.models.vae import ResnetBlock

    jpipe, params, tpipe = pipes
    x = _rand((2, 64, 64, 3), 1) * 2 - 1
    vae = {"params": params["vae"]}
    z = jax.jit(lambda p, a: jpipe.vae.apply(p, a, method=jpipe.vae.encode_mode))(vae, jnp.asarray(x))
    img = jax.jit(lambda p, a: jpipe.vae.apply(p, a, method=jpipe.vae.decode))(vae, z)
    with torch.no_grad():
        tz = tpipe.vae.encode_mode(torch.from_numpy(x))
        timg = tpipe.vae.decode(torch.from_numpy(np.array(z)))
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=ATOL, rtol=0)
    np.testing.assert_allclose(timg.numpy(), np.asarray(img), atol=ATOL, rtol=0)
    convs = [conv for block in tpipe.vae.modules() if isinstance(block, ResnetBlock) for conv in (block.conv1, block.conv2)]
    assert convs and not any("tf32_planes" in conv.__dict__.get("_derived", {}) for conv in convs)


def test_vae_runs_through_the_kernel_ops_in_channels_last(pipes, monkeypatch):
    """The path the card takes, minus the kernels: every ResnetBlock half goes
    through ``gn_silu_conv3x3`` (handed no split-tf32 weight planes: the card
    alone packs them, as the chip run's prepass tally holds), the two other norms of an encode or a decode
    through ``group_norm_silu`` and the decoder's upsamples through
    ``upsample2x_nearest``, here with their plain versions called by name;
    each is handed a contiguous NHWC view (a copy on the way would be a hidden
    transpose on the card); the result is held against the JAX VAE."""
    from instarevive_tpu_torch.models import vae as vae_mod
    from instarevive_tpu_torch.nn import layers as layers_mod
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3_plain
    from instarevive_tpu_torch.ops.norm_kernels import group_norm_silu_plain, upsample2x_nearest_plain

    jpipe, params, tpipe = pipes
    calls = {"conv": 0, "norm": 0, "up": 0}

    def counted(kind, plain):
        def op(x, *args, **kwargs):
            assert x.is_contiguous() and x.dim() == 4, (kind, x.shape, x.stride())
            calls[kind] += 1
            return plain(x, *args, **kwargs)
        return op

    def conv_without_planes(x, gamma, beta, w, bias, groups, eps, planes):
        assert planes is None
        return gn_silu_conv3x3_plain(x, gamma, beta, w, bias, groups, eps)

    monkeypatch.setattr(vae_mod, "gn_silu_conv3x3", counted("conv", conv_without_planes))
    monkeypatch.setattr(layers_mod, "group_norm_silu", counted("norm", group_norm_silu_plain))
    monkeypatch.setattr(vae_mod, "upsample2x_nearest", counted("up", upsample2x_nearest_plain))

    x = _rand((2, 64, 64, 3), 6) * 2 - 1
    vae = {"params": params["vae"]}
    z = jax.jit(lambda p, a: jpipe.vae.apply(p, a, method=jpipe.vae.encode_mode))(vae, jnp.asarray(x))
    img = jax.jit(lambda p, a: jpipe.vae.apply(p, a, method=jpipe.vae.decode))(vae, z)
    levels, blocks = len(TINY["vae"]["ch_mult"]), TINY["vae"]["num_res_blocks"]
    with torch.no_grad():
        tz = tpipe.vae.encode_mode(torch.from_numpy(x))
        assert calls == {"conv": 2 * (levels * blocks + 2), "norm": 2, "up": 0}
        calls.update(conv=0, norm=0)
        timg = tpipe.vae.decode(torch.from_numpy(np.array(z)))
        assert calls == {"conv": 2 * (levels * (blocks + 1) + 2), "norm": 2, "up": levels - 1}
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), atol=ATOL, rtol=0)
    np.testing.assert_allclose(timg.numpy(), np.asarray(img), atol=ATOL, rtol=0)


@pytest.mark.parametrize("lens", [None, [16, 5, 0]])
def test_pixart_matches_jax(pipes, lens):
    """With no mask, and with a ragged caption mask holding an empty row."""
    jpipe, params, tpipe = pipes
    rng = np.random.default_rng(2)
    z = rng.standard_normal((3, 16, 16, 4)).astype(np.float32)
    y = rng.standard_normal((3, 16, 64)).astype(np.float32)
    t = np.array([400.0, 1.0, 999.0], np.float32)
    mask = None if lens is None else np.arange(16)[None] < np.asarray(lens)[:, None]
    ref = jax.jit(jpipe.dit.apply)({"params": params["dit"]}, jnp.asarray(z), jnp.asarray(t),
                                   jnp.asarray(y), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = tpipe.dit(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y),
                        y_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_bf16_compute_keeps_f32_where_jax_does(pipes):
    """Under bf16 compute the SwinIR bias table and the adaLN tables stay f32
    and the DiT residual stream runs in f32, as in the JAX package's bf16
    mode; the port's bf16 DiT is then no farther from the f32 reference
    than the JAX package's own bf16 DiT is."""
    jpipe, params, _ = pipes
    tpipe = load_state_dicts(build_pipeline(TINY, dtype=torch.bfloat16, device="cpu"), **state_dicts_from_jax(params, TINY))
    for name, p in tpipe.named_parameters():
        keep = name.endswith(("relative_position_bias_table", "scale_shift_table"))
        assert p.dtype == (torch.float32 if keep else torch.bfloat16), name
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    y = rng.standard_normal((2, 16, 64)).astype(np.float32)
    t = np.array([400.0, 400.0], np.float32)
    args = (jnp.asarray(z), jnp.asarray(t), jnp.asarray(y))
    ref = np.asarray(jax.jit(jpipe.dit.apply)({"params": params["dit"]}, *args))
    jdit16 = jax_build_pipeline(TINY, dtype=jnp.bfloat16).dit
    jax16 = np.asarray(jax.jit(jdit16.apply)({"params": params["dit"]}, *args).astype(jnp.float32))
    residual = []
    tpipe.dit.blocks[0].register_forward_hook(lambda m, i, o: residual.append(o.dtype))
    with torch.no_grad():
        out = tpipe.dit(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(y))
    assert out.dtype == torch.bfloat16 and residual == [torch.float32]
    assert np.abs(out.float().numpy() - ref).max() <= np.abs(jax16 - ref).max()


def test_pixart_reproduces_golden():
    """tests/golden/dit_forward_tiny.npz with test_golden.py's model and inputs."""
    kw = dict(input_size=16, hidden_size=64, depth=2, num_heads=4,
              caption_channels=32, model_max_length=8)
    jdit = JaxPixArt(**kw)
    z = jax.random.normal(jax.random.key(1), (1, 16, 16, 4))
    y = jax.random.normal(jax.random.key(2), (1, 8, 32))
    params = jax.jit(jdit.init)(jax.random.key(0), z, jnp.zeros((1,)), y)["params"]
    dit = PixArt(**kw)
    dit.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         state_dicts_from_jax({"dit": params}, {"dit": kw})["dit"].items()})
    with torch.no_grad():
        out = dit(torch.from_numpy(np.array(z)), torch.tensor([400.0]), torch.from_numpy(np.array(y)))
    ref = np.load(os.path.join(REPO, "tests", "golden", "dit_forward_tiny.npz"))["out"]
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("option", [{"qk_norms": True}, {"window": 4, "window_block_indexes": [0]},
                                    {"micro_conditioning": True}, {"kv_compress": 2}])
def test_pixart_refuses_unported_options(option):
    """Every option of the JAX package's PixArt is ported (held against it in
    tests/test_torch_pixart_options.py); a key it does not have still raises."""
    with pytest.raises(TypeError):
        PixArt(hidden_size=64, depth=1, num_heads=4, caption_channels=32, **option)
