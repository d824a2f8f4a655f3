"""The port's PSNR, SSIM, MATLAB YCbCr and image panel against the JAX
package on the CPU, on numpy-seeded [0, 1] batches; 1e-5 * max(1, max|ref|)
(the JAX package computes PSNR in float32, the port in float64)."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax.numpy as jnp

from instarevive_tpu.ops.color import rgb2ycbcr_matlab as jax_rgb2ycbcr_matlab
from instarevive_tpu.utils import logging as jax_logging
from instarevive_tpu.utils import metrics as jax_metrics
from instarevive_tpu_torch.ops.color import rgb2ycbcr_matlab
from instarevive_tpu_torch.utils import logging as torch_logging
from instarevive_tpu_torch.utils import metrics


def close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def pair(seed, shape=(2, 40, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape).astype(np.float32), 0.0, 1.0)
    return a, b


@pytest.mark.parametrize("crop_border", [0, 4])
@pytest.mark.parametrize("test_y_channel", [False, True])
@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_metric_matches_jax(metric, crop_border, test_y_channel):
    a, b = pair(crop_border + 2 * test_y_channel)
    kw = dict(crop_border=crop_border, test_y_channel=test_y_channel)
    ref = getattr(jax_metrics, metric)(jnp.asarray(a), jnp.asarray(b), **kw)
    out = getattr(metrics, metric)(torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert out.shape == (2,)
    close(out.numpy(), ref)


def test_identical_images():
    a, _ = pair(7)
    t = torch.from_numpy(a)
    assert torch.all(metrics.psnr(t, t) == 120.0)  # the 1e-12 floor on the MSE
    torch.testing.assert_close(metrics.ssim(t, t), torch.ones(2), atol=1e-6, rtol=0)


@pytest.mark.parametrize("y_only", [False, True])
def test_rgb2ycbcr_matlab(y_only):
    a, _ = pair(8)
    close(rgb2ycbcr_matlab(torch.from_numpy(a), y_only=y_only).numpy(),
          jax_rgb2ycbcr_matlab(jnp.asarray(a), y_only=y_only))


@pytest.mark.parametrize("with_hq", [False, True])
def test_log_images_panel(with_hq):
    a, b = pair(9)
    hq = a[::-1].copy() if with_hq else None
    np.testing.assert_array_equal(torch_logging.log_images_panel(a, b, hq), jax_logging.log_images_panel(a, b, hq))
