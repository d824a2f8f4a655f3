"""The port's GroupNorm(+SiLU) and nearest-2x ops (plain versions, which the
CPU runs) against the JAX package's Pallas kernels in interpret mode, as
tests/test_norm_kernels.py runs them.

Tolerances. f32: the two sides sum in other orders; 2e-5 (the JAX test's own
bound against flax). bf16: both compute in f32 and round the output once;
the f32 values differ by summation order, which can carry a value across a
rounding boundary, one bf16 step at |y| < 8: 3.2e-2.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax.numpy as jnp

from instarevive_tpu.ops.gn_conv import _gn_affine as jax_gn_affine
from instarevive_tpu.ops.norm_kernels import _gn_silu_pallas, _upsample2x_pallas
from instarevive_tpu_torch.ops import cuda_build
from instarevive_tpu_torch.ops import norm_kernels as tnorm

ATOL = {"float32": 2e-5, "bfloat16": 3.2e-2}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, gamma, beta


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


# tests/test_norm_kernels.py's shapes, then odd H and W, then C a multiple of 32 only
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 4, 16, 256), (1, 5, 7, 128), (2, 3, 9, 384)])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_silu_matches_jax_pallas(shape, silu, dtype):
    x, gamma, beta = _inputs(shape)
    jx, tx = _both(x, dtype)
    ref = _gn_silu_pallas(jx, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-6, silu, interpret=True)
    out = tnorm.group_norm_silu(tx, torch.from_numpy(gamma), torch.from_numpy(beta), 32, 1e-6, silu)
    assert out.dtype == tx.dtype and tuple(out.shape) == shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 128), 32), ((1, 5, 7, 96), 32), ((1, 4, 4, 64), 8)])
def test_gn_affine_matches_jax_fold(shape, groups):
    """The fold (a, b) against ``_gn_affine`` of the JAX fused conv, which
    clamps the variance as the port does: summation order only, 1e-5."""
    x, gamma, beta = _inputs(shape, seed=1)
    ja, jb = jax_gn_affine(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-6)
    a, b = tnorm.gn_affine(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-6)
    assert a.dtype == b.dtype == torch.float32 and tuple(a.shape) == (shape[0], shape[-1])
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("value,noise", [(3.1415927, 0.0), (1000.0, 1e-5), (-77.7, 0.0)])
def test_near_constant_input_stays_finite(value, noise):
    """E[x^2] - mean^2 cancels to about 0, and in f32 sometimes below it: the
    clamp keeps the rsqrt finite, and a constant image normalises to beta
    (within the f32 error of the mean times rstd = 1000)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((value + noise * rng.standard_normal((2, 16, 16, 64))).astype(np.float32))
    beta = torch.linspace(-1.0, 1.0, 64)
    a, b = tnorm.gn_affine(x, torch.ones(64), beta)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    out = tnorm.group_norm_silu(x, torch.ones(64), beta, silu=False)
    assert torch.isfinite(out).all()
    if noise == 0.0:
        np.testing.assert_allclose(out.numpy(), np.broadcast_to(beta.numpy(), out.shape), atol=0.2)


@pytest.mark.parametrize("shape", [(2, 8, 4, 128), (1, 5, 7, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample2x_matches_jax_pallas(shape, dtype):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jx, tx = _both(x, dtype)
    ref = _upsample2x_pallas(jx, interpret=True)
    out = tnorm.upsample2x_nearest(tx)
    assert out.dtype == tx.dtype
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def test_cpu_wrappers_run_plain_versions_without_the_kernel_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(tnorm, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "load_library", refuse)
    x, gamma, beta = (torch.from_numpy(t) for t in _inputs((1, 6, 6, 64), seed=4))
    before = (tnorm.gn_affine.launches, tnorm.group_norm_silu.launches, tnorm.upsample2x_nearest.launches)
    for got, want in zip(tnorm.gn_affine(x, gamma, beta), tnorm.gn_affine_plain(x, gamma, beta)):
        assert torch.equal(got, want)
    assert torch.equal(tnorm.group_norm_silu(x, gamma, beta), tnorm.group_norm_silu_plain(x, gamma, beta))
    assert torch.equal(tnorm.upsample2x_nearest(x), tnorm.upsample2x_nearest_plain(x))
    assert before == (tnorm.gn_affine.launches, tnorm.group_norm_silu.launches, tnorm.upsample2x_nearest.launches)
    assert "norm_kernels" not in cuda_build._loaded
