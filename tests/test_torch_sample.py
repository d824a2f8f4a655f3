"""The slice as a whole on ``configs/tiny.yaml`` against the JAX package on
the CPU, and its two CLIs.

The JAX package's ``init_params`` (one ControlNet-Half stage, its projections
drawn at random so that the branch matters) go to the port through
``convert/from_jax.py``. Then, from the same initial noise, 4 guided
DPM-Solver++(2M) steps and the decode (``sample.py``'s path), and 2 control
steps of the validation path (``validate.py``'s: clean, encode, sample with
the control latent, decode), each against the same composition of the JAX
package; f32, atol 1e-5 * max(1, max|ref|) (random weights under guidance
take the latents to hundreds). Then
``python -m instarevive_tpu_torch.sample`` and ``.validate`` run in-process
with ``--device cpu``; the sample CLI also runs ``--seq_parallel 2`` and
``--pipeline_parallel 2`` on two gloo ranks that it starts itself, and refuses
the two together and more ranks than the host has cards
(``--t5_dir``: ``tests/test_torch_text_encoders.py``).
"""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)
from PIL import Image

import jax
import jax.numpy as jnp

from instarevive_tpu.config import load_config
from instarevive_tpu.diffusion.dpm_solver import dpm_solver_pp_2m as jax_dpm_solver_pp_2m
from instarevive_tpu.pipelines.build import build_pipeline as jax_build_pipeline
from instarevive_tpu.pipelines.build import init_params as jax_init_params
from instarevive_tpu_torch import sample, validate
from instarevive_tpu_torch.convert.from_jax import state_dicts_from_jax
from instarevive_tpu_torch.data.dataset import closest_bucket
from instarevive_tpu_torch.pipelines.build import build_pipeline, load_state_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_PATH = os.path.join(REPO, "configs", "tiny.yaml")
TINY = load_config(TINY_PATH)
CFG = 4.5


def close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_build_pipeline(TINY, control_depth=1)
    params = jax_init_params(jpipe, seed=0)
    rng = np.random.default_rng(1)
    for name in ("controlnet_before_proj", "controlnet_0_after_proj"):
        params["dit"][name] = {k: jnp.asarray(0.2 * rng.standard_normal(v.shape), jnp.float32)
                               for k, v in params["dit"][name].items()}
    tpipe = load_state_dicts(build_pipeline(TINY, device="cpu", control_depth=1), **state_dicts_from_jax(params, TINY))
    return jpipe, params, tpipe


def test_guided_sampling_matches_jax(pipes):
    """sample.py's classifier-free guidance around 4 DPM-Solver++(2M) steps,
    then the decode: random captions against the learned null embedding."""
    jpipe, params, tpipe = pipes
    rng = np.random.default_rng(2)
    shape = (2, 16, 16, 4)
    x_init = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal((2, 16, 64)).astype(np.float32)
    null = np.repeat(np.asarray(params["dit"]["y_embedder"]["y_embedding"])[None], 2, axis=0)

    @jax.jit
    def jax_sample(params, x, y, null):
        def cfg_eps(x, t):  # the root sample.py's guidance
            out = jpipe.dit.apply({"params": params["dit"]}, jnp.concatenate([x, x]),
                                  jnp.concatenate([t, t]).astype(jnp.float32), jnp.concatenate([y, null]))
            ce, ue = jnp.split(out[..., :4], 2, axis=0)
            half = ue + CFG * (ce - ue)
            return jnp.concatenate([jnp.concatenate([half, half]), out[..., 4:]], axis=-1)[: x.shape[0]]

        z = jax_dpm_solver_pp_2m(lambda x, t: cfg_eps(x, t)[..., :4], jpipe.sched, x, steps=4)
        return z, jpipe.decode(params, z)

    z_ref, img_ref = jax_sample(params, jnp.asarray(x_init), jnp.asarray(y), jnp.asarray(null))
    z = sample.sample_latents(tpipe, torch.from_numpy(y), torch.from_numpy(null), shape, algo="dpm-solver", step=4,
                              cfg_scale=CFG, x_init=torch.from_numpy(x_init))
    close(z, z_ref)
    with torch.inference_mode():
        img = tpipe.decode(z)
    close(img, img_ref)


def test_control_sampling_matches_jax(pipes):
    """validate.py's path for 2 steps: clean, encode to the control latent,
    DPM-Solver++(2M) with the ControlNet-Half DiT, decode."""
    jpipe, params, tpipe = pipes
    rng = np.random.default_rng(3)
    lq = rng.random((2, 64, 64, 3), dtype=np.float32)
    z_init = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    y = np.array(params["dit"]["y_embedder"]["y_embedding"])[None]

    @jax.jit
    def jax_validate(params, lq, z_init):
        stage1 = jpipe.clean(params, lq)
        c = jpipe.encode(params, stage1)
        yy = jnp.repeat(jnp.asarray(y), lq.shape[0], axis=0)

        def eps_fn(z, t):
            return jpipe.dit.apply({"params": params["dit"]}, z, t.astype(jnp.float32), yy, c=c,
                                   control_depth=1)[..., :4]

        return jpipe.decode(params, jax_dpm_solver_pp_2m(eps_fn, jpipe.sched, z_init, steps=2)), stage1

    pred_ref, stage1_ref = jax_validate(params, jnp.asarray(lq), jnp.asarray(z_init))
    pred, stage1 = validate.restore_batch(tpipe, torch.from_numpy(y), torch.from_numpy(lq), torch.from_numpy(z_init),
                                          steps=2)
    close(stage1, stage1_ref)
    close(pred, pred_ref)


@pytest.mark.parametrize("algo", sample.ALGOS)
def test_sample_cli_writes_images(algo, tmp_path):
    """2 steps (SA-Solver's predictor of order 3 needs 3) at 64x64."""
    argv = ["--device", "cpu", "--random_init", "--config", TINY_PATH, "--output", str(tmp_path),
            "--step", "3" if algo == "sa-solver" else "2", "--sampling_algo", algo, "--image_size", "64",
            "--prompt", "a photo", "a cat"]
    paths = sample.main(argv)
    assert [os.path.basename(p) for p in paths] == [f"sample_{i}_{algo}.png" for i in range(2)]
    for path in paths:
        img = np.asarray(Image.open(path))
        assert img.shape == (64, 64, 3) and img.std() > 0


def test_aspect_suffix_picks_the_bucket():
    h, w = (int(v) for v in closest_bucket(0.5))
    assert sample.latent_shape(["a photo", "a cat --ar 1:2"], 512) == (2, h // 8, w // 8, 4)
    assert sample.latent_shape(["a photo"], 256, 4) == (1, 64, 64, 4)


@pytest.mark.parametrize("flag", ["--seq_parallel", "--pipeline_parallel"])
def test_sample_cli_runs_a_mesh_flag_on_two_ranks(flag, tmp_path):
    """The CLI starts two gloo ranks itself (no WORLD_SIZE), splits the
    guided DiT call over them (tokens, or the blocks in two stages with two
    microbatches) and writes from rank 0 the images a one-process run writes,
    within one 8-bit level (the split changes the order of the sums)."""
    argv = ["--device", "cpu", "--random_init", "--config", TINY_PATH, "--step", "2", "--image_size", "64",
            "--prompt", "a photo", "a cat"]
    one = sample.main(argv + ["--output", str(tmp_path / "one")])
    assert sample.main(argv + ["--output", str(tmp_path / "two"), flag, "2"]) is None  # the launching process
    for path in one:
        two = np.asarray(Image.open(tmp_path / "two" / os.path.basename(path)), np.int16)
        assert np.abs(two - np.asarray(Image.open(path), np.int16)).max() <= 1


def test_sample_cli_refuses_both_mesh_flags(capsys):
    with pytest.raises(SystemExit) as e:
        sample.parse_args(["--device", "cpu", "--seq_parallel", "2", "--pipeline_parallel", "2"])
    assert e.value.code == 2 and "mutually exclusive" in capsys.readouterr().err


def test_sample_cli_refuses_more_ranks_than_cards():
    """On the card (the default device) a mesh flag needs that many cards;
    it never falls back to the CPU."""
    with pytest.raises(SystemExit, match=f"this host has {torch.cuda.device_count()} CUDA devices"):
        sample.main(["--random_init", "--config", TINY_PATH, "--seq_parallel", str(torch.cuda.device_count() + 2)])


def test_validate_cli_writes_panels(tmp_path):
    src, out = tmp_path / "hq", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (80, 72, 3), dtype=np.uint8)).save(src / f"{i}.png")
    result = validate.main(["--device", "cpu", "--random_init", "--config", TINY_PATH, "--data", str(src),
                            "--out", str(out), "--crop_size", "64", "--batch_size", "2", "--step", "2",
                            "--control_depth", "1"])
    assert result["n"] == 3 and np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])
    panels = sorted(os.listdir(out))
    assert panels == ["b0_0.png", "b0_1.png", "b1_0.png"]
    assert np.asarray(Image.open(out / "b1_0.png")).shape == (64, 192, 3)  # lq | prediction | hq
