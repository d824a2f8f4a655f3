"""The port's Swin window attention (ops/swin_attention.py) on the CPU, where
its wrapper runs the plain version, against the JAX package's Pallas kernel
in interpret mode on the same numpy-seeded inputs: f32, atol = rtol = 2e-5
(the two sum in other orders). The JAX kernel leaves the cyclic roll outside,
so the shifted cases put ``jnp.roll`` around it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from instarevive_tpu.ops import window as JW
from instarevive_tpu.ops.swin_attention import swin_window_attention as jax_swin_window_attention
from instarevive_tpu_torch.ops import window as TW
from instarevive_tpu_torch.ops.swin_attention import (
    heads_per_block, swin_window_attention, swin_window_attention_plain,
)

TOL = 2e-5
WINDOW = 8


def _inputs(b, h, w, heads, hd, shift, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    c = heads * hd
    qkv = rng.standard_normal((b, h, w, 3 * c)).astype(np.float32)
    bias = (rng.standard_normal((heads, WINDOW**2, WINDOW**2)) * 0.1).astype(np.float32)
    mask = np.asarray(JW.shift_attn_mask(h, w, WINDOW, shift)) if shift and masked else None
    return qkv, bias, mask


def _jax_side(qkv, bias, mask, heads, scale, shift):
    x = jnp.asarray(qkv)
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
    out = jax_swin_window_attention(x, jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
                                    heads, WINDOW, scale, interpret=True)
    if shift:
        out = jnp.roll(out, (shift, shift), axis=(1, 2))
    return np.asarray(out)


def _torch_side(qkv, bias, mask, heads, scale, shift, fn=swin_window_attention):
    return fn(torch.from_numpy(qkv), torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask),
              heads, WINDOW, scale, shift).numpy()


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (2, 16, 24), (1, 24, 16)])
@pytest.mark.parametrize("hd", [10, 30])
def test_matches_the_jax_kernel_in_interpret_mode(b, h, w, hd, shift):
    heads = 6
    qkv, bias, mask = _inputs(b, h, w, heads, hd, shift)
    scale = hd**-0.5
    want = _jax_side(qkv, bias, mask, heads, scale, shift)
    got = _torch_side(qkv, bias, mask, heads, scale, shift)
    assert got.shape == (b, h, w, heads * hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shift", [0, 3])
def test_no_mask_and_an_odd_shift(shift):
    """``mask=None`` with a roll: the windows then wrap without a mask, which
    the function allows (the mask is the caller's)."""
    qkv, bias, _ = _inputs(2, 16, 16, 3, 8, shift, seed=1, masked=False)
    want = _jax_side(qkv, bias, None, 3, 0.3, shift)
    got = _torch_side(qkv, bias, None, 3, 0.3, shift)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_own_mask_and_index_equal_the_jax_packages():
    for h, w in ((16, 16), (16, 24), (64, 48)):
        np.testing.assert_array_equal(TW.shift_attn_mask(h, w, 8, 4), np.asarray(JW.shift_attn_mask(h, w, 8, 4)))
    np.testing.assert_array_equal(TW.relative_position_index(8), np.asarray(JW.relative_position_index(8)))


def test_shift_is_roll_attend_roll_back():
    """The shifted function is the unshifted one between two rolls, token for
    token: a single window row or column wraps around the map's edge."""
    qkv, bias, mask = _inputs(1, 16, 24, 2, 6, 4, seed=2)
    t = torch.from_numpy
    rolled = torch.roll(t(qkv), (-4, -4), dims=(1, 2))
    inner = swin_window_attention(rolled, t(bias), t(mask), 2, WINDOW, 0.4, 0)
    want = torch.roll(inner, (4, 4), dims=(1, 2))
    got = swin_window_attention(t(qkv), t(bias), t(mask), 2, WINDOW, 0.4, 4)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_bf16_rounds_once_at_the_end():
    """bf16 in: scores, softmax and P.V in f32, one rounding of the output."""
    qkv, bias, mask = _inputs(1, 16, 16, 6, 10, 4, seed=3)
    t = torch.from_numpy
    q16 = t(qkv).to(torch.bfloat16)
    out = swin_window_attention(q16, t(bias), t(mask), 6, WINDOW, 0.3, 4)
    ref = swin_window_attention_plain(q16.float(), t(bias), t(mask), 6, WINDOW, 0.3, 4)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.to(torch.bfloat16), atol=0, rtol=0)


@pytest.mark.parametrize("bad,match", [
    (dict(h=12), "multiples of window"),
    (dict(w=20), "multiples of window"),
    (dict(shift=8), "shift must be"),
    (dict(shift=-1), "shift must be"),
    (dict(channels=100), "3 \\* heads \\* hd"),
    (dict(dims=3), "3 \\* heads \\* hd"),
])
def test_refuses_sizes_it_cannot_run(bad, match):
    h, w, c3 = bad.get("h", 16), bad.get("w", 16), bad.get("channels", 3 * 6 * 10)
    qkv = torch.zeros(1, h, w, c3)
    if bad.get("dims") == 3:
        qkv = qkv[0]
    with pytest.raises(ValueError, match=match):
        swin_window_attention(qkv, torch.zeros(6, 64, 64), None, 6, WINDOW, 1.0, bad.get("shift", 0))


def test_heads_per_block_fills_the_card():
    """The bf16 kernel's grid is windows x head groups: as many heads a block
    as leave one block for each of the card's SMs."""
    assert [heads_per_block(6, w, 132) for w in (4, 64, 96, 256, 1024)] == [1, 2, 3, 6, 6]
    assert heads_per_block(4, 64, 132) == 1 and heads_per_block(4, 256, 132) == 4
    assert heads_per_block(7, 1000, 132) == 1 and heads_per_block(12, 1000, 132) == 6
