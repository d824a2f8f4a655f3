"""Port building blocks against the JAX package: config, schedules,
eps -> x0, timestep embedding, pixel (un)shuffle, window helpers, nearest
resize, depthwise filtering and the color fixes (f32, atol 1e-5)."""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax.numpy as jnp

from instarevive_tpu import config as jconfig
from instarevive_tpu.diffusion import one_step as jone_step
from instarevive_tpu.diffusion import schedules as jsched
from instarevive_tpu.nn import layers as jlayers
from instarevive_tpu.ops import color as jcolor
from instarevive_tpu.ops import window as jwindow
from instarevive_tpu.ops.filters import depthwise_conv2d as jax_depthwise_conv2d
from instarevive_tpu.ops.resize import interpolate as jax_interpolate
from instarevive_tpu_torch import config as tconfig
from instarevive_tpu_torch.diffusion import one_step as tone_step
from instarevive_tpu_torch.diffusion import schedules as tsched
from instarevive_tpu_torch.nn import layers as tlayers
from instarevive_tpu_torch.ops import color as tcolor
from instarevive_tpu_torch.ops import window as twindow
from instarevive_tpu_torch.ops.filters import depthwise_conv2d
from instarevive_tpu_torch.ops.resize import interpolate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.numpy() if isinstance(out, torch.Tensor) else out,
                               np.asarray(ref), atol=atol, rtol=0)


def test_config_load_and_merge():
    path = os.path.join(REPO, "configs", "instarevive_v1.yaml")
    cfg = tconfig.load_config(path)
    assert cfg == jconfig.load_config(path)
    over = {"dit": {"depth": 2}, "maxt": 300}
    assert tconfig.merge(cfg, over) == jconfig.merge(cfg, over)
    assert cfg["dit"]["depth"] == 28  # merge copies, never edits its input


def test_schedule_and_eps_to_x0():
    js, ts = jsched.make_schedule("linear", 1000), tsched.make_schedule("linear", 1000)
    _close(ts.betas, js.betas, atol=0)
    _close(ts.alphas_cumprod, js.alphas_cumprod, atol=0)
    t = np.array([400, 0, 999])
    _close(tsched.extract(ts.alphas_cumprod, torch.from_numpy(t), 4),
           jsched.extract(js.alphas_cumprod, jnp.asarray(t), 4), atol=0)
    eps, x_t = _rand((3, 8, 8, 4), 1), _rand((3, 8, 8, 4), 2)
    _close(tone_step.eps_to_x0(ts, torch.from_numpy(eps), torch.from_numpy(x_t), torch.from_numpy(t)),
           jone_step.eps_to_x0(js, jnp.asarray(eps), jnp.asarray(x_t), jnp.asarray(t)), atol=2e-4)


@pytest.mark.parametrize("dim", [256, 7])
def test_timestep_embedding(dim):
    # arguments reach 999 rad, where one f32 step is 6.1e-5: the two exp
    # implementations may put t * freq one step apart, so 1e-4
    t = np.array([0.0, 1.0, 400.0, 999.0], np.float32)
    _close(tlayers.timestep_embedding(torch.from_numpy(t), dim),
           jlayers.timestep_embedding(jnp.asarray(t), dim), atol=1e-4)


def test_gelu_and_pixel_shuffle():
    x = _rand((2, 16, 24, 3))
    _close(tlayers.gelu_tanh(torch.from_numpy(x)), jlayers.gelu_tanh(jnp.asarray(x)))
    un = tlayers.pixel_unshuffle(torch.from_numpy(x), 8)
    _close(un, jlayers.pixel_unshuffle(jnp.asarray(x), 8), atol=0)
    _close(tlayers.pixel_shuffle(un, 8), x, atol=0)


def test_window_helpers():
    x = _rand((2, 16, 24, 5))
    wins = twindow.window_partition(torch.from_numpy(x), 8)
    _close(wins, jwindow.window_partition(jnp.asarray(x), 8), atol=0)
    _close(twindow.window_reverse(wins, 8, 16, 24), x, atol=0)
    np.testing.assert_array_equal(twindow.relative_position_index(8), jwindow.relative_position_index(8))
    np.testing.assert_array_equal(twindow.shift_attn_mask(16, 24, 8, 4), jwindow.shift_attn_mask(16, 24, 8, 4))
    _close(twindow.cyclic_shift(torch.from_numpy(x), 4), jwindow.cyclic_shift(jnp.asarray(x), 4), atol=0)
    _close(twindow.cyclic_unshift(torch.from_numpy(x), 4), jwindow.cyclic_unshift(jnp.asarray(x), 4), atol=0)
    for mode in ("reflect", "constant"):
        got, h, w = twindow.pad_to_multiple(torch.from_numpy(x[:, :13, :21]), 8, mode=mode)
        ref, rh, rw = jwindow.pad_to_multiple(jnp.asarray(x[:, :13, :21]), 8, mode=mode)
        assert (h, w) == (rh, rw) == (13, 21)
        _close(got, ref, atol=0)


def test_nearest_interpolate():
    x = _rand((2, 5, 7, 3))
    _close(interpolate(torch.from_numpy(x), scale_factor=2, mode="nearest"), jax_interpolate(jnp.asarray(x), scale_factor=2, mode="nearest"), atol=0)
    nchw = interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2, mode="nearest", spatial_axes=(-2, -1))
    _close(nchw.permute(0, 2, 3, 1), jax_interpolate(jnp.asarray(x), scale_factor=2, mode="nearest"), atol=0)


@pytest.mark.parametrize("dilation,pad_mode", [(1, "edge"), (4, "edge"), (2, "reflect")])
def test_depthwise_conv2d(dilation, pad_mode):
    x, k = _rand((2, 20, 24, 3), 3), _rand((3, 3), 4)
    _close(depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(k), dilation, pad_mode),
           jax_depthwise_conv2d(jnp.asarray(x), jnp.asarray(k), dilation, pad_mode))


def test_color_fixes():
    rng = np.random.default_rng(5)
    content = rng.random((2, 64, 64, 3), dtype=np.float32)
    style = rng.random((2, 64, 64, 3), dtype=np.float32)
    _close(tcolor.wavelet_color_fix(torch.from_numpy(content), torch.from_numpy(style)),
           jcolor.wavelet_color_fix(jnp.asarray(content), jnp.asarray(style)))
    _close(tcolor.adain_color_fix(torch.from_numpy(content), torch.from_numpy(style)),
           jcolor.adain_color_fix(jnp.asarray(content), jnp.asarray(style)))
