"""The port's restoration pipeline against the JAX package end to end
(tiny config, f32 on the CPU, atol 2e-4), its CLI, and that it never
imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from instarevive_tpu.config import load_config
from instarevive_tpu.pipelines.build import build_pipeline as jax_build_pipeline
from instarevive_tpu.pipelines.build import init_params as jax_init_params
from instarevive_tpu_torch.convert.from_jax import state_dicts_from_jax
from instarevive_tpu_torch.pipelines.build import build_pipeline, load_checkpoint, load_state_dicts
from instarevive_tpu_torch.pipelines.restore import auto_tile_geometry, tile_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = load_config(os.path.join(REPO, "configs", "tiny.yaml"))
ATOL = 2e-4


@pytest.fixture(scope="module")
def pipes():
    """test_golden.py's JAX pipeline and params, and the port loaded with them."""
    jpipe = jax_build_pipeline(TINY)
    params = jax_init_params(jpipe, seed=0)
    tpipe = load_state_dicts(build_pipeline(TINY, device="cpu"), **state_dicts_from_jax(params, TINY))
    return jpipe, params, tpipe


def test_process_matches_jax_and_golden(pipes):
    """test_golden.py's inputs; the golden file holds the JAX output."""
    jpipe, params, tpipe = pipes
    y = jnp.zeros((1, TINY["dit"]["model_max_length"], TINY["dit"]["caption_channels"]))
    lq = jnp.clip(jax.random.uniform(jax.random.key(7), (1, 64, 64, 3)), 0, 1)
    ref = np.asarray(jpipe.jitted()(params, lq, y))
    out = tpipe.process(torch.from_numpy(np.array(lq)), torch.from_numpy(np.array(y))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    golden = np.load(os.path.join(REPO, "tests", "golden", "pipeline_process_tiny.npz"))["out"]
    np.testing.assert_allclose(out, golden, atol=ATOL, rtol=0)


def test_process_tiled_matches_jax(pipes):
    """128x128 with tile 64 / stride 32: a 3x3 tile grid, batch 2, a ragged
    caption mask; the JAX side batches 3 tiles per DiT call, the port 4."""
    jpipe, params, tpipe = pipes
    rng = np.random.default_rng(3)
    lq = rng.random((2, 128, 128, 3), dtype=np.float32)
    y = rng.standard_normal((2, 16, 64)).astype(np.float32)
    mask = np.arange(16)[None] < np.array([[16], [9]])
    kw = dict(tile_size=64, tile_stride=32)
    ref = np.asarray(jpipe.jitted(tiled=True, **kw)(params, jnp.asarray(lq), jnp.asarray(y), jnp.asarray(mask)))
    out = tpipe.process_tiled(torch.from_numpy(lq), torch.from_numpy(y), torch.from_numpy(mask), **kw)
    assert len(tile_grid(16, 16, 8, 4)) == 9
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_auto_tile_geometry():
    assert auto_tile_geometry(1024, 1024) == (576, 512)
    assert auto_tile_geometry(2048, 2048) == (576, 512)
    assert auto_tile_geometry(448, 448)[0] == 448


def test_state_dict_files_load(pipes, tmp_path):
    """Saved reference-layout state dicts load back exactly; buffers the
    reference stores but the port computes are dropped; a diffusers-layout
    PixArt dict that lacks keys the model needs names the first of them."""
    _, params, tpipe = pipes
    sds = state_dicts_from_jax(params, TINY)
    for name, sd in sds.items():
        extra = {"layers.0.residual_group.blocks.1.attn_mask": np.zeros(1), "pos_embed": np.zeros(1)}
        torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in {**sd, **extra}.items()}},
                   tmp_path / f"{name}.pth")
    fresh = load_state_dicts(build_pipeline(TINY, device="cpu"), **{n: load_checkpoint(str(tmp_path / f"{n}.pth")) for n in sds})
    for (k, a), b in zip(tpipe.state_dict().items(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)
    with pytest.raises(KeyError, match="pos_embed.proj.weight"):
        load_state_dicts(fresh, dit={"transformer_blocks.0.attn1.to_q.weight": np.zeros((2, 2))})


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import instarevive_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('instarevive_tpu_torch.')]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_cli_runs_on_cpu(tmp_path):
    from PIL import Image

    from instarevive_tpu_torch import inference

    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)).save(src / "x.png")
    inference.main(["--input", str(src), "--output", str(dst), "--device", "cpu", "--random_init",
                    "--config", os.path.join(REPO, "configs", "tiny.yaml")])
    out = Image.open(dst / "x.png")
    assert out.size == (854, 512)  # short edge raised to 512, aspect kept
    assert np.asarray(out).std() > 0
