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
