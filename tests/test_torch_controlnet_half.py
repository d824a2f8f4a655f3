"""The port's ControlNet-Half DiT against the JAX package on the CPU.

The projections are zero at init, so on fresh weights the branch changes
nothing: both sides get the same random projections instead (normal, scale
0.2). A tiny PixArt (depth 4, ControlNet-Half depth 2) through
``convert/from_jax.py``, ``process(use_control=True)`` on ``configs/tiny.yaml``
(depth 2, one control stage), and the loader: both checkpoint layouts carry
the branch in, and a checkpoint without it leaves the model's own. f32,
atol 1e-4 (the JAX package's own PixArt tests' bound)."""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.config import load_config
from instarevive_tpu.convert.torch_export import pixart_params_to_diffusers
from instarevive_tpu.models.pixart import PixArt as JaxPixArt
from instarevive_tpu.pipelines.build import build_pipeline as jax_build_pipeline
from instarevive_tpu.pipelines.build import init_params as jax_init_params
from instarevive_tpu_torch.convert.from_jax import pixart_params_to_torch, state_dicts_from_jax
from instarevive_tpu_torch.models.pixart import PixArt
from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params, load_state_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = load_config(os.path.join(REPO, "configs", "tiny.yaml"))
ATOL = 1e-4
SMALL = dict(input_size=16, patch_size=2, in_channels=4, hidden_size=64, depth=4, num_heads=4, mlp_ratio=2.0,
             caption_channels=32, model_max_length=8)


def randomize_projections(dit_params, seed):
    """The JAX DiT params with every ControlNet-Half projection drawn
    N(0, 0.2^2) (numpy), instead of its zero init."""
    rng = np.random.default_rng(seed)
    out = dict(dit_params)
    for name, leaf in dit_params.items():
        if name.startswith("controlnet_") and name.endswith("proj"):
            out[name] = {k: jnp.asarray(0.2 * rng.standard_normal(v.shape), jnp.float32) for k, v in leaf.items()}
    return out


@pytest.fixture(scope="module")
def small():
    """A depth-4 JAX PixArt with two control stages and random projections,
    and the port's, built with control_depth 2, loaded from it."""
    jmodel = JaxPixArt(**SMALL)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 16, 16, 4)), jnp.float32)
    c = jnp.asarray(rng.standard_normal((2, 16, 16, 4)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((2, 8, 32)), jnp.float32)
    t = jnp.asarray([400.0, 37.5])
    params = jax.jit(lambda k: jmodel.init(k, x, t, y, c=c, control_depth=2))(jax.random.key(1))["params"]
    params = randomize_projections(params, 2)
    model = PixArt(**SMALL, control_depth=2)
    sd = pixart_params_to_torch(params, depth=4)
    assert {k for k in sd if k.startswith("controlnet.")} == {k for k in model.state_dict() if k.startswith("controlnet.")}
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return jmodel, params, model, (x, t, y, c)


@pytest.mark.parametrize("control_depth", [2, 1])
def test_controlnet_half_matches_jax(small, control_depth):
    jmodel, params, model, (x, t, y, c) = small
    mask = jnp.asarray(np.arange(8)[None] < np.array([[8], [5]]))
    apply = jax.jit(jmodel.apply, static_argnames=("control_depth",))
    ref = np.asarray(apply({"params": params}, x, t, y, y_mask=mask, c=c, control_depth=control_depth))
    args = [torch.from_numpy(np.array(a)) for a in (x, t, y)]
    with torch.no_grad():
        out = model(*args, y_mask=torch.from_numpy(np.array(mask)), c=torch.from_numpy(np.array(c)),
                    control_depth=control_depth).numpy()
        plain = model(*args, y_mask=torch.from_numpy(np.array(mask))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert np.abs(out - plain).max() > 1e-2  # the random projections move the output


def test_control_depth_is_checked():
    with pytest.raises(ValueError):
        PixArt(**SMALL, control_depth=4)
    model = PixArt(**SMALL, control_depth=1)
    x = torch.zeros(1, 16, 16, 4)
    with pytest.raises(ValueError):
        model(x, torch.zeros(1), torch.zeros(1, 8, 32), c=x, control_depth=2)


@pytest.fixture(scope="module")
def pipes():
    """The JAX tiny pipeline with one control stage and random projections,
    and the port's loaded from it through the converter; VAE and DiT only
    (``process`` runs with ``use_swinir=False``)."""
    jpipe = jax_build_pipeline(TINY, control_depth=1)
    params = jax_init_params(jpipe, seed=0, components=("vae", "dit"))
    params["dit"] = randomize_projections(params["dit"], 3)
    tpipe = load_state_dicts(build_pipeline(TINY, device="cpu", control_depth=1, components=("vae", "dit")),
                             **state_dicts_from_jax(params, TINY))
    return jpipe, params, tpipe


def test_process_with_control_matches_jax(pipes):
    jpipe, params, tpipe = pipes
    rng = np.random.default_rng(4)
    lq = rng.random((2, 64, 64, 3), dtype=np.float32)
    y = rng.standard_normal((2, 16, 64)).astype(np.float32)
    kw = dict(use_swinir=False)
    ref = np.asarray(jpipe.jitted(use_control=True, **kw)(params, jnp.asarray(lq), jnp.asarray(y)))
    out = tpipe.process(torch.from_numpy(lq), torch.from_numpy(y), use_control=True, **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    plain = tpipe.process(torch.from_numpy(lq), torch.from_numpy(y), **kw).numpy()
    assert np.abs(out - plain).max() > 1e-3
    # one tile over the whole image: the tiled call conditions each tile on its own latent, here the same one
    tiled = tpipe.process_tiled(torch.from_numpy(lq), torch.from_numpy(y), tile_size=64, tile_stride=32,
                                use_control=True, **kw).numpy()
    np.testing.assert_allclose(tiled, out, atol=1e-6, rtol=0)


def test_loader_carries_the_branch(pipes):
    """Native and diffusers layouts load the branch into a pipeline built
    with it; a DiT checkpoint without it leaves the seeded branch, whose
    zero projections make ``use_control`` change nothing."""
    _, params, tpipe = pipes
    want = tpipe.dit.state_dict()
    diffusers = pixart_params_to_diffusers(params["dit"], depth=TINY["dit"]["depth"])
    assert any(k.startswith("controlnet.0.copied_block.attn1.") for k in diffusers)
    got = load_state_dicts(init_params(build_pipeline(TINY, device="cpu", control_depth=1, components=("dit",)),
                                       seed=9), dit=diffusers).dit.state_dict()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0, msg=k)

    plain_sd = {k: v for k, v in state_dicts_from_jax(params, TINY)["dit"].items() if not k.startswith("controlnet.")}
    fresh = init_params(build_pipeline(TINY, device="cpu", control_depth=1, components=("vae", "dit")), seed=9)
    seeded = {k: v.clone() for k, v in fresh.dit.state_dict().items() if k.startswith("controlnet.")}
    assert not any(v.abs().max() for k, v in seeded.items() if "_proj." in k)
    load_state_dicts(fresh, dit=plain_sd)
    for k, v in seeded.items():
        torch.testing.assert_close(fresh.dit.state_dict()[k], v, atol=0, rtol=0, msg=k)
    lq, y = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(5)), torch.zeros(1, 16, 64)
    torch.testing.assert_close(fresh.process(lq, y, use_control=True, use_swinir=False),
                               fresh.process(lq, y, use_swinir=False), atol=0, rtol=0)
