"""The port's plain versions of the flash-attention backward and of the
forward's log-sum-exp (instarevive_tpu_torch/ops/attention.py) against the JAX
package: ``jax.vjp`` through its Pallas ``flash_attention`` (dq and dk/dv
kernels) run in interpret mode, and its forward's ``emit_lse`` output; and
against torch autograd through the port's ``sdpa``, one fully masked row
included. Same numpy inputs from a seed, f32, 2e-5 of each output's largest
magnitude. The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from instarevive_tpu.ops.attention import _flash_fwd_impl as jax_flash_fwd_impl
from instarevive_tpu.ops.attention import flash_attention as jax_flash_attention
from instarevive_tpu_torch.ops import attention as tattn

REL = 2e-5  # f32 on both sides: only the order of the sums differs


def _inputs(b, h, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s, dtype=np.float32)
                   for s in ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d), (b, h, nq, d)))
    return q, k, v, do


def _mask(b, nk, lens):
    return None if lens is None else np.arange(nk)[None] < np.asarray(lens)[:, None]


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _plain_backward(q, k, v, mask, do):
    """The port's forward (sdpa, flash_lse_plain), then flash_backward_plain."""
    q, k, v, mask, do = (_t(x) for x in (q, k, v, mask, do))
    scale = q.shape[-1] ** -0.5
    o = tattn.sdpa(q, k, v, kv_mask=mask, scale=scale)
    lse = tattn.flash_lse_plain(q, k, mask, scale)
    return tattn.flash_backward_plain(q, k, v, mask, o, lse, do, scale)


def _assert_close(got, want, names=("dq", "dk", "dv")):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= REL * np.abs(b).max(), (name, np.abs(a - b).max(), np.abs(b).max())


CASES = {
    "unmasked": (2, 2, 256, 256, 64, None),
    "masked": (2, 2, 256, 256, 64, [100, 200]),
    "ragged_cross": (1, 2, 200, 300, 64, [250]),
    "head_dim_72": (1, 2, 130, 77, 72, None),
    "unet_mid_4_keys": (2, 2, 64, 4, 64, None),  # head dim 64 at the UNet's middle block over the zero context
}


@pytest.mark.parametrize("case", list(CASES))
def test_backward_plain_matches_jax_flash_vjp_interpret(case):
    b, h, nq, nk, d, lens = CASES[case]
    q, k, v, do = _inputs(b, h, nq, nk, d, seed=7)
    mask = _mask(b, nk, lens)
    jmask = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q, k, v: jax_flash_attention(q, k, v, kv_mask=jmask, block_q=128, block_k=128),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    _assert_close([g.numpy() for g in _plain_backward(q, k, v, mask, do)], want)


@pytest.mark.parametrize("masked", [False, True])
def test_lse_plain_matches_jax_forward_emit_lse_interpret(masked):
    b, h, n, d = 2, 2, 256, 64
    q, k, v, _ = _inputs(b, h, n, n, d, seed=9)
    mask = _mask(b, n, [100, 256]) if masked else np.ones((b, n), bool)
    maskf = jnp.repeat(jnp.asarray(mask, jnp.float32)[:, None, :], h, axis=0).reshape(b * h, 1, n)
    flat = [jnp.asarray(x).reshape(b * h, n, d) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        _, lse = jax_flash_fwd_impl(*flat, maskf, d**-0.5, masked, 128, 128, True)
    got = tattn.flash_lse_plain(_t(q), _t(k), _t(mask) if masked else None, d**-0.5)
    np.testing.assert_allclose(got.numpy().reshape(b * h, n), np.asarray(lse)[..., 0], atol=2e-5, rtol=0)


@pytest.mark.parametrize("d", [64, 72])
@pytest.mark.parametrize("lens", [None, [30, 7, 19], [30, 0, 19]], ids=["unmasked", "masked", "one_row_fully_masked"])
def test_backward_plain_matches_autograd_through_sdpa(lens, d):
    """A sample with no real key gets the mean of V over the Nk keys in the
    forward; its gradient is dV = dO / Nk on every key and nothing to q, k."""
    b, h, nq, nk = 3, 2, 40, 30
    q, k, v, do = _inputs(b, h, nq, nk, d, seed=3)
    mask = _mask(b, nk, lens)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(tattn.sdpa(*leaves, kv_mask=_t(mask)), leaves, _t(do))
    got = _plain_backward(q, k, v, mask, do)
    _assert_close([g.numpy() for g in got], [g.numpy() for g in want])
    if lens is not None and 0 in lens:
        dead = lens.index(0)
        assert got[0][dead].abs().max() == 0 and got[1][dead].abs().max() == 0
        np.testing.assert_allclose(got[2][dead, :, 0].numpy(), do[dead].sum(1) / nk, atol=1e-5)


def test_lse_of_a_fully_masked_row_is_the_flag():
    q, k, _, _ = _inputs(2, 1, 5, 9, 8, seed=1)
    lse = tattn.flash_lse_plain(_t(q), _t(k), _t(_mask(2, 9, [0, 4])))
    assert (lse[0] == tattn.NEG_INF).all() and (lse[0] < tattn.DEAD_ROW).all()
    assert (lse[1] > tattn.DEAD_ROW).all()


def test_bf16_plain_rounds_p_and_ds_to_the_operand_dtype():
    """In bf16 the plain backward stays within a few bf16 steps of the f32 one
    and returns bf16."""
    q, k, v, do = _inputs(1, 2, 64, 48, 72, seed=5)
    f32 = _plain_backward(q, k, v, None, do)
    b16 = [_t(x).bfloat16() for x in (q, k, v, do)]
    scale = 72**-0.5
    o = tattn.sdpa(b16[0], b16[1], b16[2], scale=scale)
    lse = tattn.flash_lse_plain(b16[0], b16[1], None, scale)
    got = tattn.flash_backward_plain(b16[0], b16[1], b16[2], None, o, lse, b16[3], scale)
    for a, b in zip(got, f32):
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).abs().max() <= 3e-2 * b.abs().max()


def test_cpu_wrappers_use_the_plain_versions_and_torch_autograd():
    q, k, v, do = (_t(x) for x in _inputs(1, 2, 16, 12, 72, seed=2))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tattn.attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    lse = tattn.flash_lse_plain(q, k)
    via_wrapper = tattn.flash_backward(q, k, v, None, out.detach(), lse, do, 72**-0.5)
    _assert_close([g.numpy() for g in via_wrapper], [g.numpy() for g in grads])
    assert tattn.flash_attention.launches == 0 or not torch.cuda.is_available()
    assert tattn.flash_dq.launches == 0 and tattn.flash_dkv.launches == 0
