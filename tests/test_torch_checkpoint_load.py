"""The port's checkpoint loader against the JAX package's CLI loader
(``instarevive_tpu.pipelines.build.load_params``) on the files the JAX CLI
loads: the diffusers-layout DiT of the product checkpoint (with and without
its caption embedding, and with ControlTransformerHalf's ``.base_block.``
keys), an EMA-wrapped native DiT, a DDP-saved (``module.``) SwinIR and a
``model.``-prefixed VAE, written with ``torch.save`` from tiny parameters made
from a seed and exported by the JAX package's own exporters.

``load_params`` random-initialises every model before it loads a file; here
that initialisation is a second seeded tree (``init_params`` patched for the
test), which keeps its JAX compile out of the run and leaves the loader's own
steps (unwrap, prefix, layout, key map, the kept caption embedding) as they
are."""

import argparse
import copy
import os
import re

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.config import load_config
from instarevive_tpu.convert import torch_export as jax_export
from instarevive_tpu.pipelines import build as jax_build
from instarevive_tpu_torch.convert.from_jax import state_dicts_from_jax
from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params, load_checkpoint, load_state_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = load_config(os.path.join(REPO, "configs", "tiny.yaml"))
PROCESS_ATOL = 1e-4  # f32 on the CPU: the two packages sum in other orders


def _seeded_tree(shapes, seed):
    """Numpy leaves in the shapes of ``shapes``: kernels N(0, 1/fan_in), norm
    scales near 1, every other leaf N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(s.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        else:
            x = 1 + 0.05 * x if name == "scale" else 0.05 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _files(src, out):
    """The checkpoint files of each case: case -> (model, path)."""
    sw, vae, depth = TINY["swinir"], TINY["vae"], TINY["dit"]["depth"]
    diffusers = _torch(jax_export.pixart_params_to_diffusers(src["dit"], depth=depth))
    native_dit = _torch(jax_export.pixart_params_to_torch(src["dit"], depth=depth))
    swinir = _torch(jax_export.swinir_params_to_torch(src["swinir"], depths=tuple(sw["depths"]), sf=sw["sf"],
                                                      unshuffle=sw["unshuffle"]))
    # buffers the reference stores and both packages compute
    swinir["layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(4, 64, 64)
    swinir["layers.0.residual_group.blocks.0.attn.relative_position_index"] = torch.zeros(64, 64, dtype=torch.long)
    vae_sd = _torch(jax_export.vae_params_to_torch(src["vae"], ch_mult=tuple(vae["ch_mult"]),
                                                   num_res_blocks=vae["num_res_blocks"]))
    base_block = {re.sub(r"^(transformer_blocks\.\d+)\.", r"\1.base_block.", k): v for k, v in diffusers.items()}
    # a ControlNet-Half part the tiny config does not build
    base_block.update({"controlnet.0.after_proj.weight": torch.zeros(64, 64), "controlnet.0.after_proj.bias": torch.zeros(64)})
    contents = {
        "dit_diffusers": ("dit", diffusers),
        "dit_diffusers_without_y_embedding": ("dit", {k: v for k, v in diffusers.items()
                                                      if k != "caption_projection.y_embedding"}),
        "dit_diffusers_base_block": ("dit", base_block),
        "dit_ema_native": ("dit", {"state_dict_ema": native_dit, "step": 3}),
        "swinir_module_prefix": ("swinir", {f"module.{k}": v for k, v in swinir.items()}),
        "vae_model_prefix": ("vae", {f"model.{k}": v for k, v in vae_sd.items()}),
        # a Lightning file: the weights beside a pickled config, which only a full unpickle reads
        "vae_lightning_with_config": ("vae", {"state_dict": vae_sd, "hyper_parameters": argparse.Namespace(ch=32)}),
    }
    files = {}
    for case, (model, obj) in contents.items():
        torch.save(obj, out / f"{case}.pth")
        files[case] = (model, str(out / f"{case}.pth"))
    return files


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jpipe = jax_build.build_pipeline(TINY)
    key, img = jax.random.key(0), jnp.zeros((1, 64, 64, 3))
    y = jnp.zeros((1, TINY["dit"]["model_max_length"], TINY["dit"]["caption_channels"]))
    shapes = {"swinir": jax.eval_shape(jpipe.swinir.init, key, img)["params"],
              "vae": jax.eval_shape(jpipe.vae.init, key, img)["params"],
              "dit": jax.eval_shape(jpipe.dit.init, key, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), y)["params"]}
    src, random_init = _seeded_tree(shapes, 1), _seeded_tree(shapes, 2)
    return jpipe, random_init, _files(src, tmp_path_factory.mktemp("ckpt"))


def _jax_load(setup, monkeypatch, **paths):
    jpipe, random_init, _ = setup
    monkeypatch.setattr(jax_build, "init_params", lambda pipe, seed=0: copy.deepcopy(random_init))
    return jax_build.load_params(jpipe, **paths)


def _port_load(**paths):
    pipe = init_params(build_pipeline(TINY, device="cpu"), seed=0)
    own = pipe.dit.y_embedder.y_embedding.detach().clone()
    return load_state_dicts(pipe, **{model: load_checkpoint(path) for model, path in paths.items()}), own


ARGS = {"swinir": "swinir_ckpt", "vae": "vae_ckpt", "dit": "dit_ckpt"}


@pytest.mark.parametrize("case", ["dit_diffusers", "dit_diffusers_without_y_embedding", "dit_diffusers_base_block",
                                  "dit_ema_native", "swinir_module_prefix", "vae_model_prefix",
                                  "vae_lightning_with_config"])
def test_port_loads_what_the_jax_cli_loads(setup, monkeypatch, case):
    """The port's state dicts equal the JAX package's conversion of what its
    CLI loaded, bit for bit; without a caption embedding in the file the
    port keeps its own, as the JAX CLI keeps its random one. A file that
    pickles more than tensors is refused by both unless
    ``IR_UNSAFE_TORCH_LOAD=1``."""
    model, path = setup[2][case]
    if case == "vae_lightning_with_config":
        monkeypatch.delenv("IR_UNSAFE_TORCH_LOAD", raising=False)
        for load in (lambda: _jax_load(setup, monkeypatch, vae_ckpt=path), lambda: load_checkpoint(path)):
            with pytest.raises(RuntimeError, match="IR_UNSAFE_TORCH_LOAD=1"):
                load()
        monkeypatch.setenv("IR_UNSAFE_TORCH_LOAD", "1")
    params = _jax_load(setup, monkeypatch, **{ARGS[model]: path})
    want = state_dicts_from_jax({model: params[model]}, TINY)[model]
    pipe, own_y = _port_load(**{model: path})
    got = getattr(pipe, model).state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if case == "dit_diffusers_without_y_embedding" and key == "y_embedder.y_embedding":
            assert torch.equal(got[key], own_y) and not np.array_equal(got[key].numpy(), value)
        else:
            assert got[key].dtype == torch.float32 and got[key].shape == value.shape, key
            np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_loaded_pipeline_processes_as_the_jax_package(setup, monkeypatch):
    """All three models from their files (the ``.base_block.`` DiT, the
    ``module.`` SwinIR, the ``model.`` VAE) through both loaders, then one
    tiny ``process`` in f32 on the CPU."""
    jpipe, files = setup[0], setup[2]
    paths = {m: files[c][1] for m, c in (("swinir", "swinir_module_prefix"), ("vae", "vae_model_prefix"),
                                         ("dit", "dit_diffusers_base_block"))}
    params = _jax_load(setup, monkeypatch, **{ARGS[m]: p for m, p in paths.items()})
    pipe, _ = _port_load(**paths)
    rng = np.random.default_rng(5)
    lq = rng.random((1, 64, 64, 3), dtype=np.float32)
    y = rng.standard_normal((1, TINY["dit"]["model_max_length"], TINY["dit"]["caption_channels"])).astype(np.float32)
    ref = np.asarray(jpipe.jitted()(params, jnp.asarray(lq), jnp.asarray(y)))
    with torch.no_grad():
        out = pipe.process(torch.from_numpy(lq), torch.from_numpy(y)).numpy()
    assert out.shape == ref.shape == (1, 64, 64, 3) and out.std() > 0.01
    np.testing.assert_allclose(out, ref, atol=PROCESS_ATOL, rtol=0)
