"""The port's own copy of the JAX -> torch key maps against the JAX package's
exporters, bit for bit, and a static check that the port imports neither JAX
nor the JAX package."""

import ast
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from instarevive_tpu.config import load_config
from instarevive_tpu.convert import torch_export as jax_export
from instarevive_tpu.pipelines.build import build_pipeline as jax_build_pipeline
from instarevive_tpu_torch.convert import from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = load_config(os.path.join(REPO, "configs", "tiny.yaml"))


@pytest.fixture(scope="module")
def params():
    jpipe = jax_build_pipeline(TINY)
    k1, k2, k3 = jax.random.split(jax.random.key(11), 3)
    y = jnp.zeros((1, TINY["dit"]["model_max_length"], TINY["dit"]["caption_channels"]))
    return {
        "swinir": jax.jit(jpipe.swinir.init)(k1, jnp.zeros((1, 64, 64, 3)))["params"],
        "vae": jax.jit(jpipe.vae.init)(k2, jnp.zeros((1, 64, 64, 3)))["params"],
        "dit": jax.jit(jpipe.dit.init)(k3, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), y)["params"],
    }


def _jax_side(model, params):
    if model == "swinir":
        sw = TINY["swinir"]
        return jax_export.swinir_params_to_torch(params["swinir"], depths=tuple(sw["depths"]), sf=sw["sf"],
                                                 unshuffle=sw["unshuffle"])
    if model == "vae":
        vae = TINY["vae"]
        return jax_export.vae_params_to_torch(params["vae"], ch_mult=tuple(vae["ch_mult"]),
                                              num_res_blocks=vae["num_res_blocks"])
    return jax_export.pixart_params_to_torch(params["dit"], depth=TINY["dit"]["depth"])


@pytest.mark.parametrize("model", ["swinir", "vae", "dit"])
def test_own_exporters_equal_the_jax_packages(params, model):
    want = _jax_side(model, params)
    got = from_jax.state_dicts_from_jax({model: params[model]}, TINY)[model]
    assert list(got) == list(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_own_dit_exporter_equals_the_jax_packages_with_every_option():
    """A DiT tree with every optional leaf: ``uniform`` compression, qk-norm and
    micro-conditioning as the JAX package builds them, plus the ``conv``
    compression's ``sr`` and ``norm`` added by hand to two blocks (the JAX
    package cannot build that form), bit for bit."""
    from instarevive_tpu.models.pixart import PixArt as JaxPixArt

    cfg = dict(TINY["dit"], kv_compress_sampling="uniform", kv_compress_ratio=2, kv_compress_layers=[0],
               qk_norm=True, micro_condition=True)
    y = jnp.zeros((1, cfg["model_max_length"], cfg["caption_channels"]))
    shapes = jax.eval_shape(JaxPixArt(**cfg).init, jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                            y)["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    c, r = cfg["hidden_size"], 2
    for i in range(cfg["depth"]):
        params[f"blocks_{i}"]["attn"]["sr"] = {"kernel": rng.standard_normal((r, r, 1, c)).astype(np.float32),
                                               "bias": rng.standard_normal(c).astype(np.float32)}
        params[f"blocks_{i}"]["attn"]["norm"] = {"scale": rng.standard_normal(c).astype(np.float32),
                                                 "bias": rng.standard_normal(c).astype(np.float32)}
    want = jax_export.pixart_params_to_torch(params, depth=cfg["depth"])
    got = from_jax.state_dicts_from_jax({"dit": params}, {"dit": cfg})["dit"]
    assert list(got) == list(want)
    for key in ("blocks.1.attn.sr.weight", "blocks.0.attn.norm.bias", "blocks.0.attn.q_norm.weight",
                "blocks.1.attn.k_norm.bias", "csize_embedder.mlp.0.weight", "ar_embedder.mlp.2.bias"):
        assert key in got
    assert got["blocks.0.attn.sr.weight"].shape == (c, 1, r, r)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


CLDM_TINY = load_config(os.path.join(REPO, "configs", "cldm_tiny.yaml"))


@pytest.mark.parametrize("model", ["unet", "controlnet"])
def test_own_unet_exporter_equals_the_jax_packages(model):
    """The UNet / ControlNet map (openaimodel keys) on a cldm_tiny tree made
    from a seed in the shapes ``jax.eval_shape`` gives, bit for bit; and the
    train-state carry of the LDM stack names its leaves ``unet.*`` and
    ``controlnet.*``."""
    from instarevive_tpu.models.unet import UNetBackbone

    sec = CLDM_TINY[model]
    x = jnp.zeros((1, 8, 8, sec["in_channels"]))
    shapes = jax.eval_shape(UNetBackbone(**{k: tuple(v) if isinstance(v, list) else v for k, v in sec.items()}).init,
                            jax.random.key(0), x, jnp.zeros((1,)), jnp.zeros((1, 4, sec["context_dim"])))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    want = jax_export.unet_params_to_torch(params, channel_mult=tuple(sec["channel_mult"]),
                                           num_res_blocks=sec["num_res_blocks"], attention_ds=tuple(sec["attention_ds"]),
                                           is_controlnet=bool(sec.get("is_controlnet", False)))
    got = from_jax.state_dicts_from_jax({model: params}, CLDM_TINY)[model]
    assert list(got) == list(want) and (("middle_block_out.0.weight" in got) == (model == "controlnet"))
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    other = "controlnet" if model == "unet" else "unet"
    tree = {model: params, other: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), jax.eval_shape(
            UNetBackbone(**{k: tuple(v) if isinstance(v, list) else v for k, v in CLDM_TINY[other].items()}).init,
            jax.random.key(0), jnp.zeros((1, 8, 8, CLDM_TINY[other]["in_channels"])), jnp.zeros((1,)),
            jnp.zeros((1, 4, CLDM_TINY[other]["context_dim"])))["params"])}
    names = [f"{model}.{k}" for k in list(got)[:3]]
    state = from_jax.cldm_train_state_from_jax(tree, tree, tree, tree, 2, names, CLDM_TINY, step=2)
    assert set(state["params"]) == {f"{m}.{k}" for m in ("unet", "controlnet")
                                    for k in from_jax.state_dicts_from_jax({m: tree[m]}, CLDM_TINY)[m]}
    assert list(state["ema"]) == names and len(state["opt_state"]["inner"]["mu"]) == 3 and state["step"] == 2
    np.testing.assert_array_equal(state["opt_state"]["inner"]["nu"][0], got[names[0].split(".", 1)[1]])


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "instarevive_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 20 and any(f.endswith("from_jax.py") for f in files)
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "instarevive_tpu"}
    bad = {os.path.relpath(f, REPO): sorted(_imported_roots(f) & banned) for f in files}
    assert not {f: b for f, b in bad.items() if b}
