"""The port's filtering ops (instarevive_tpu_torch/ops/filters.py) against the
JAX package on the CPU: ``filter2d_plain``, which is what ``filter2d`` takes on
a CPU tensor and what the CUDA kernel is held against on the card, against the
JAX ``filter2d`` and against the Pallas kernel in interpret mode; the Gaussian
blur and USM sharpening; the wrapper's dispatch and refusals."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax.numpy as jnp

from instarevive_tpu.ops import filters as jax_filters
from instarevive_tpu_torch.ops import filters

# Both sides sum kh * kw products of numbers below 1 in f32, in another order.
TOL = 1e-5


def _inputs(shape, k, per_sample, seed):
    rng = np.random.default_rng(seed)
    img = rng.random(shape, dtype=np.float32)
    kh, kw = (k, k) if isinstance(k, int) else k
    kernel = rng.random((shape[0], kh, kw) if per_sample else (kh, kw), dtype=np.float32) - 0.2  # some negative taps
    kernel /= np.abs(kernel).sum(axis=(-2, -1), keepdims=True)
    return img, kernel


CASES = {
    "per_sample_7_rgb": ((2, 24, 40, 3), 7, True),
    "per_sample_21_rgb": ((2, 32, 48, 3), 21, True),
    "per_sample_41_rgb": ((2, 48, 64, 3), 41, True),
    "shared_21_rgb": ((3, 40, 24, 3), 21, False),
    "per_sample_7_gray": ((2, 16, 56, 1), 7, True),
    "shared_41_gray": ((1, 64, 48, 1), 41, False),
    "rectangular_taps": ((2, 24, 40, 3), (5, 11), True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_filter2d_plain_matches_jax_filter2d(name):
    shape, k, per_sample = CASES[name]
    img, kernel = _inputs(shape, k, per_sample, seed=len(name))
    want = np.asarray(jax_filters.filter2d(jnp.asarray(img), jnp.asarray(kernel)))
    got = filters.filter2d_plain(torch.from_numpy(img), torch.from_numpy(kernel))
    assert got.shape == img.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL
    # the wrapper on a CPU tensor is the plain version, bit for bit
    assert torch.equal(filters.filter2d(torch.from_numpy(img), torch.from_numpy(kernel)), got)


PALLAS_CASES = {  # the TPU kernel wants H a multiple of 8
    "21_rgb": ((2, 32, 136, 3), 21, True),
    "7_nonsquare_gray": ((1, 48, 24, 1), 7, True),
    "41_rgb": ((1, 48, 40, 3), 41, True),
    "13_shared": ((2, 24, 64, 3), 13, False),
}


@pytest.mark.parametrize("name", list(PALLAS_CASES))
def test_filter2d_plain_matches_the_pallas_kernel_in_interpret_mode(name):
    shape, k, per_sample = PALLAS_CASES[name]
    img, kernel = _inputs(shape, k, per_sample, seed=3 + len(name))
    per = kernel if per_sample else np.broadcast_to(kernel[None], (shape[0], *kernel.shape))
    want = np.asarray(jax_filters._filter2d_pallas(jnp.asarray(img), jnp.asarray(per), interpret=True))
    got = filters.filter2d_plain(torch.from_numpy(img), torch.from_numpy(kernel))
    assert np.abs(got.numpy() - want).max() <= TOL


RAGGED_CASES = {  # shapes the card kernel's tiles (16 R rows x 96 flats, channel bands) do not divide
    "gray_37x53_k21": ((2, 37, 53, 1), 21, True),
    "two_channels_45x29_k13": ((1, 45, 29, 2), 13, True),
    "five_channels_19x27_k7": ((2, 19, 27, 5), 7, True),
    "c64_24x30_k41": ((1, 24, 30, 64), 41, True),
    "c128_18x22_k5x9": ((1, 18, 22, 128), (5, 9), True),
    "reflect_limit_21x21_k41_shared": ((1, 21, 21, 2), 41, False),
    "pitch_390_floats_90x130": ((2, 90, 130, 3), (5, 13), True),
}


@pytest.mark.parametrize("name", list(RAGGED_CASES))
def test_filter2d_plain_matches_jax_at_ragged_shapes(name):
    shape, k, per_sample = RAGGED_CASES[name]
    img, kernel = _inputs(shape, k, per_sample, seed=11 + len(name))
    want = np.asarray(jax_filters.filter2d(jnp.asarray(img), jnp.asarray(kernel)))
    got = filters.filter2d_plain(torch.from_numpy(img), torch.from_numpy(kernel))
    assert np.abs(got.numpy() - want).max() <= TOL


RAGGED_PALLAS_CASES = {  # ragged W and odd channel counts that _pallas_filter_ok still admits (H a multiple of 8)
    "five_channels_w131_k21": ((1, 16, 131, 5), 21, True),
    "gray_w200_k7_shared": ((2, 24, 200, 1), 7, False),
    "two_channels_w130_k5x13": ((1, 8, 130, 2), (5, 13), True),
}


@pytest.mark.parametrize("name", list(RAGGED_PALLAS_CASES))
def test_filter2d_plain_matches_the_pallas_kernel_at_ragged_shapes(name):
    shape, k, per_sample = RAGGED_PALLAS_CASES[name]
    kh, kw = (k, k) if isinstance(k, int) else k
    assert jax_filters._pallas_filter_ok(shape[1], shape[2], kh, kw)
    img, kernel = _inputs(shape, k, per_sample, seed=5 + len(name))
    per = kernel if per_sample else np.broadcast_to(kernel[None], (shape[0], *kernel.shape))
    want = np.asarray(jax_filters._filter2d_pallas(jnp.asarray(img), jnp.asarray(per), interpret=True))
    got = filters.filter2d_plain(torch.from_numpy(img), torch.from_numpy(kernel))
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("dilation", [2, 3])
def test_dilated_filter2d_matches_jax(dilation):
    img, kernel = _inputs((2, 32, 40, 3), 5, True, seed=9)
    want = np.asarray(jax_filters.filter2d(jnp.asarray(img), jnp.asarray(kernel), dilation=dilation))
    got = filters.filter2d(torch.from_numpy(img), torch.from_numpy(kernel), dilation=dilation)
    assert np.abs(got.numpy() - want).max() <= TOL


def test_filter2d_reflects_without_repeating_the_edge():
    """A ramp along x filtered with a one-sided kernel: reflect (-1 -> 1) and
    edge repeat (-1 -> 0) give different first columns."""
    img = torch.arange(8, dtype=torch.float32).reshape(1, 1, 8, 1).expand(1, 4, 8, 1).contiguous()
    kernel = torch.zeros(3, 3)
    kernel[1, 0] = 1.0  # reads the left neighbour
    out = filters.filter2d(img, kernel)
    assert out[0, 0, :, 0].tolist() == [1.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]


def test_gaussian_kernels_blur_and_usm_match_jax():
    for ksize, sigma in ((51, 0.0), (21, 3.0), (7, 1.5)):
        assert np.array_equal(filters.gaussian_kernel1d(ksize, sigma), jax_filters.gaussian_kernel1d(ksize, sigma))
        assert np.array_equal(filters.gaussian_kernel2d(ksize, sigma), jax_filters.gaussian_kernel2d(ksize, sigma))
    img = np.random.default_rng(3).random((2, 56, 60, 3), dtype=np.float32)
    got = filters.gaussian_blur(torch.from_numpy(img), 21, 2.0)
    assert np.abs(got.numpy() - np.asarray(jax_filters.gaussian_blur(jnp.asarray(img), 21, 2.0))).max() <= TOL
    got = filters.usm_sharpen(torch.from_numpy(img))
    want = np.asarray(jax_filters.usm_sharpen(jnp.asarray(img)))
    # the threshold mask |residual| * 255 > 10 is a comparison: where the two packages' blurs straddle it the
    # mask flips, and the flipped pixel's 51-tap neighbourhood moves by up to its tap weight
    diff = np.abs(got.numpy() - want)
    assert (diff <= TOL).mean() >= 0.999 and diff.max() <= 1e-3


def test_cpu_dispatch_never_reaches_the_kernel(monkeypatch):
    def boom(name):
        raise AssertionError("the CUDA library must not be loaded for a CPU tensor")

    monkeypatch.setattr(filters, "load_library", boom)
    filters._kernel.cache_clear()
    img, kernel = _inputs((1, 16, 16, 3), 7, True, seed=0)
    before = filters.filter2d.launches
    filters.filter2d(torch.from_numpy(img), torch.from_numpy(kernel))
    filters.filter2d(torch.from_numpy(img).double(), torch.from_numpy(kernel))  # any dtype on the CPU
    assert filters.filter2d.launches == before and filters.filter2d.shapes is None


def test_filter2d_refusals():
    img, kernel = _inputs((2, 16, 16, 3), 7, True, seed=0)
    img, kernel = torch.from_numpy(img), torch.from_numpy(kernel)
    with pytest.raises(ValueError, match="B, H, W, C"):
        filters.filter2d(img[0], kernel)
    with pytest.raises(ValueError, match="kernel must be"):
        filters.filter2d(img, kernel[:1])
    with pytest.raises(ValueError, match="kernel must be"):
        filters.filter2d(img, kernel[None])
    with pytest.raises(RuntimeError):  # reflect is undefined once the padding reaches the image size
        filters.filter2d(torch.rand(1, 8, 8, 3), torch.rand(1, 21, 21))
