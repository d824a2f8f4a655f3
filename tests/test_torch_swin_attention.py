"""The port's Swin window attention (ops/swin_attention.py) on the CPU, where
its wrapper runs the plain version, against the JAX package's Pallas kernel
in interpret mode on the same numpy-seeded inputs: f32, atol = rtol = 2e-5
(the two sum in other orders). The JAX kernel leaves the cyclic roll outside,
so the shifted cases put ``jnp.roll`` around it. Beside it, plain-torch
emulations of the card's two forms' arithmetic (the f32 form's split-tf32
products, the bf16 form's P in two bf16 terms) against the same JAX kernel,
and the rule that sizes the kernel's work items."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from instarevive_tpu.ops import window as JW
from instarevive_tpu.ops.swin_attention import swin_window_attention as jax_swin_window_attention
from instarevive_tpu_torch.ops import window as TW
from instarevive_tpu_torch.ops.swin_attention import (
    heads_per_item, ring_geometry, swin_window_attention, swin_window_attention_plain,
)
from instarevive_tpu_torch.ops.tf32_planes import tf32_round

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


def test_heads_per_item_balances_the_busiest_sm():
    """A work item is a window with a group of heads. Its block takes 8 warps
    (16 when the items are no more than the SMs) and two fit an SM; the rule
    picks the size that the card takes in one wave with the least work on
    the busiest SM, the larger on a tie, and the largest where none gives one
    wave. The figures at 6 heads of 30 are the fastest size at each shape on
    the card; f32 blocks hold 3 heads at most."""
    assert [ring_geometry(g, 30, 2) for g in (1, 2, 3, 6)] == [(4, 2), (3, 2), (2, 2), (1, 2)]
    assert [ring_geometry(g, 30, 4) for g in (1, 2, 3, 6)] == [(4, 2), (2, 2), (1, 2), (0, 0)]
    windows = (64, 80, 96, 104, 256)
    assert [heads_per_item(6, 30, w, 132, True) for w in windows] == [3, 6, 6, 6, 6]
    assert [heads_per_item(6, 30, w, 132, False) for w in windows] == [3, 2, 3, 3, 3]
    assert heads_per_item(6, 30, 1, 132, True) == 3 and heads_per_item(6, 30, 4096, 132, True) == 6
    assert heads_per_item(4, 32, 1000, 132, True) == 4 and heads_per_item(8, 32, 1000, 132, False) == 2
    assert heads_per_item(3, 7, 8, 132, False) == 3 and heads_per_item(1, 32, 8, 132, True) == 1


def _windows(x, shift):
    """(B, H, W, C) -> (B * nW, 64, C), rolled by -shift."""
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    return TW.window_partition(x, WINDOW)


def _unwindows(o, b, h, w, shift):
    o = TW.window_reverse(o, WINDOW, h, w)
    return torch.roll(o, (shift, shift), dims=(1, 2)) if shift else o


def _scores(qkv, bias, mask, heads, scale, shift, product):
    """q, k, v split by head and the masked, scaled scores, with Q.K^T taken by ``product``."""
    b, h, w, c3 = qkv.shape
    hd = c3 // 3 // heads
    q, k, v = _windows(qkv, shift).reshape(-1, 64, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = product(q, k.transpose(-1, -2)) * scale + bias[None]
    if mask is not None:
        s = s + mask.repeat(b, 1, 1)[:, None]
    return s, v


def _split_product(a, b):
    """lo.hi + hi.lo + hi.hi of tf32-split operands, each product exact, summed in f32."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_f32_form(qkv, bias, mask, heads, scale, shift):
    """The f32 kernel's arithmetic: split-tf32 Q.K^T, f32 softmax left
    unnormalised, split-tf32 P.V, one division by the row sum."""
    b, h, w, c3 = qkv.shape
    s, v = _scores(qkv, bias, mask, heads, scale, shift, _split_product)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _split_product(p, v) / p.sum(-1, keepdim=True)
    return _unwindows(o.transpose(1, 2).reshape(-1, 64, c3 // 3), b, h, w, shift)


def _emulated_bf16_form(qkv, bias, mask, heads, scale, shift):
    """The bf16 kernel's arithmetic on bf16 q, k, v: exact products summed in
    f32, f32 softmax, P as two bf16 terms (hi = bf16(p), lo = bf16(p - hi)),
    P.V in f32, one division, one rounding to bf16."""
    b, h, w, c3 = qkv.shape
    s, v = _scores(qkv.float(), bias, mask, heads, scale, shift, torch.matmul)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    o = (hi @ v + lo @ v) / p.sum(-1, keepdim=True)
    return _unwindows(o.transpose(1, 2).reshape(-1, 64, c3 // 3), b, h, w, shift).to(torch.bfloat16)


# The f32 form against the JAX kernel (plain f32): the split keeps about 21
# bits of each product (lo.lo, 2^-22 of it, dropped) and the two sum in other
# orders; with |scores| and |out| of a few units: chip_smoke.py's bound, 1e-5.
F32_FORM_BOUND = 1e-5
# The bf16 form against the f32 reference on the same bf16-valued q, k, v:
# half a bf16 step of the output below 1 (2^-9) plus summation order; 2.1e-3.
BF16_FORM_BOUND = 2.1e-3


@pytest.mark.parametrize("shift", [0, 3, 4])
@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (2, 16, 24), (1, 24, 16)])
@pytest.mark.parametrize("hd", [10, 30])
def test_emulated_f32_form_matches_the_jax_kernel(b, h, w, hd, shift):
    heads = 6
    qkv, bias, mask = _inputs(b, h, w, heads, hd, shift)
    scale = hd**-0.5
    want = _jax_side(qkv, bias, mask, heads, scale, shift)
    t = torch.from_numpy
    got = _emulated_f32_form(t(qkv), t(bias), None if mask is None else t(mask), heads, scale, shift).numpy()
    np.testing.assert_allclose(got, want, atol=F32_FORM_BOUND, rtol=0)


@pytest.mark.parametrize("shift", [0, 3, 4])
@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (2, 16, 24), (1, 24, 16)])
@pytest.mark.parametrize("hd", [10, 30])
def test_emulated_bf16_form_is_near_the_f32_reference(b, h, w, hd, shift):
    """v in [-1, 1] as on the card, so |out| <= 1; the reference is the JAX
    kernel in f32 on the same bf16-valued inputs."""
    heads = 6
    qkv, bias, mask = _inputs(b, h, w, heads, hd, shift)
    c = heads * hd
    qkv[..., 2 * c:] = np.random.default_rng(5).uniform(-1, 1, qkv[..., 2 * c:].shape)
    q16 = torch.from_numpy(qkv).to(torch.bfloat16)
    scale = hd**-0.5
    want = _jax_side(q16.float().numpy(), bias, mask, heads, scale, shift)
    got = _emulated_bf16_form(q16, torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask), heads,
                              scale, shift)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_FORM_BOUND, rtol=0)
