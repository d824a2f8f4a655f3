"""Port attention (instarevive_tpu_torch/ops/attention.py) against the JAX
package: plain ``sdpa`` against JAX ``sdpa`` and against the JAX Pallas
flash kernel run in interpret mode, and CPU dispatch never reaching the
CUDA kernel library. The kernel itself is held against ``sdpa`` on the card
by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.ops.attention import flash_attention as jax_flash_attention
from instarevive_tpu.ops.attention import sdpa as jax_sdpa
from instarevive_tpu_torch.ops import attention as tattn
from instarevive_tpu_torch.ops import cuda_build


def _qkv(b, h, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d))]


def _ragged_mask(b, nk, lens):
    return np.arange(nk)[None] < np.asarray(lens)[:, None]


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize(
    "case",
    ["plain", "mask", "mask_all_false_row", "bias", "bias_and_mask"],
)
def test_sdpa_matches_jax_sdpa(case):
    b, h, nq, nk, d = 3, 2, 40, 30, 16
    q, k, v = _qkv(b, h, nq, nk, d, seed=1)
    mask = bias = None
    if "mask" in case:
        mask = _ragged_mask(b, nk, [30, 0 if "all_false" in case else 7, 19])
    if "bias" in case:
        bias = np.random.default_rng(2).standard_normal((1, h, nq, nk)).astype(np.float32)
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   bias=None if bias is None else jnp.asarray(bias),
                   kv_mask=None if mask is None else jnp.asarray(mask))
    out = tattn.sdpa(_t(q), _t(k), _t(v), bias=_t(bias), kv_mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "b,h,nq,nk,d,lens",
    [
        (1, 2, 70, 45, 72, None),          # DiT head dim, ragged Nq and Nk
        (2, 3, 130, 300, 72, [300, 123]),  # caption-length keys, ragged mask
        (1, 1, 33, 100, 512, None),        # VAE mid-block head dim
        (2, 1, 20, 77, 512, [77, 5]),
        (1, 1, 81, 81, 512, None),         # the card's 64-row blocks and 32-key tiles, ragged
        (2, 1, 65, 129, 512, [129, 40]),
        (2, 2, 64, 4, 64, None),           # UNet head dim: the middle block's 64 queries over a 4-key context
        (1, 2, 100, 77, 64, [40]),         # ragged queries over a CLIP-length, masked context
    ],
)
def test_sdpa_matches_jax_flash_interpret(b, h, nq, nk, d, lens):
    """Online-softmax summation order differs from one softmax: 2e-5."""
    q, k, v = _qkv(b, h, nq, nk, d, seed=3)
    mask = None if lens is None else _ragged_mask(b, nk, lens)
    from jax.experimental.pallas import tpu as pltpu

    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  kv_mask=None if mask is None else jnp.asarray(mask),
                                  block_q=128, block_k=128)
    out = tattn.sdpa(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_cpu_dispatch_never_touches_kernel_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("CPU attention reached the CUDA kernel library")

    monkeypatch.setattr(tattn, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "load_library", refuse)
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 24, 16, 72, seed=4))
    mask = torch.from_numpy(_ragged_mask(2, 16, [16, 3]))
    before = tattn.flash_attention.launches
    ref = tattn.sdpa(q, k, v, kv_mask=mask)
    for out in (tattn.attention(q, k, v, kv_mask=mask), tattn.flash_attention(q, k, v, kv_mask=mask)):
        torch.testing.assert_close(out, ref, atol=0, rtol=0)
    biased = tattn.attention(q, k, v, bias=torch.zeros(1, 4, 24, 16))
    torch.testing.assert_close(biased, tattn.sdpa(q, k, v), atol=1e-6, rtol=0)
    assert tattn.flash_attention.launches == before
    assert "flash_attn_fwd" not in cuda_build._loaded
