"""The split-tf32 form of the f32 flash attention (K1 at head dims 64, 72 and
512 and K2 at 64 and 72 on the card), on the CPU: ``tf32_planes_plain``, the
bit-exact plain version of the prepass ``csrc/tf32_planes.cu``, and an
emulation of the kernels' arithmetic in plain torch (every product as
hi.hi + hi.lo + lo.hi of planes from ``tf32_planes_plain``, f32 matmuls)
through the forward and its VJP, held to the port's unchanged f32 bounds
against the JAX package's ``flash_attention`` and ``jax.vjp`` run in
interpret mode (at head dim 512 the forward alone, as the head-dim-512
kernel computes it, also held to 1e-4 of the reference's largest
magnitude). The kernels themselves are held against the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from instarevive_tpu.ops.attention import _flash_fwd_impl as jax_flash_fwd_impl
from instarevive_tpu.ops.attention import flash_attention as jax_flash_attention
from instarevive_tpu.ops.attention import sdpa as jax_sdpa
from instarevive_tpu_torch.ops import attention as tattn
from instarevive_tpu_torch.ops import tf32_planes as tplanes

OUT_BOUND = 1e-4   # chip_smoke.py BOUNDS["f32"]: the output, |out| <= 1
OUT_REL = 1e-4     # REL_BOUNDS["f32"], of the reference output's largest magnitude
LSE_BOUND = 1e-4   # LSE_BOUNDS["f32"]
GRAD_REL = 2e-5    # BACKWARD_BOUNDS["f32"], of each gradient's largest magnitude


def _bits(x):
    return torch.tensor(np.array(x, dtype=np.uint32).view(np.int32)).view(torch.float32)


def _as_bits(x):
    return x.view(torch.int32).numpy().view(np.uint32).tolist()


@pytest.mark.parametrize("given,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a tf32 value
    (0x3F801000, 0x3F802000),  # a tie whose lower neighbour is even: away from zero, not to even
    (0xBF801000, 0xBF802000),  # the same tie below zero
    (0x3F800FFF, 0x3F800000),  # just under half a tf32 step
    (0x3F801001, 0x3F802000),  # just over
    (0x3FFFF000, 0x40000000),  # the carry reaches the exponent
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x80000000, 0x80000000),  # -0
], ids=["one", "tie", "negative_tie", "under", "over", "carry", "subnormal", "negative_zero"])
def test_tf32_round_is_round_to_nearest_ties_away(given, want):
    assert _as_bits(tplanes.tf32_round(_bits([given]))) == [want]


def test_planes_have_13_zero_bits_and_sum_to_the_operand():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 50, 72)).astype(np.float32) * np.exp(rng.uniform(-20, 20, (3, 4, 50, 72))).astype(np.float32)
    x = torch.from_numpy(x)
    hi, lo, t_hi, t_lo = tplanes.tf32_planes_plain(x)
    assert t_hi is None and t_lo is None
    for p in (hi, lo):
        assert (p.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi.double() + lo.double()) - x.double()).abs().le(2.0**-22 * x.double().abs()).all()
    assert torch.equal(hi, tplanes.tf32_round(x)) and torch.equal(lo, tplanes.tf32_round(x - hi))


@pytest.mark.parametrize("n", [77, 300, 1000, 4, 8])
def test_transposed_planes_invert_back_to_the_operand(n):
    """(..., d, pad8(n)): zeros past n, the sequence in the order PERM8 within
    each group of 8; undoing the order, the padding and the transpose gives
    the natural planes."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, 3, n, 64)).astype(np.float32))
    hi, lo, t_hi, t_lo = tplanes.tf32_planes_plain(x, natural=True, transposed=True)
    n_pad = tplanes.pad8(n)
    assert n_pad % 8 == 0 and n <= n_pad < n + 8 and t_hi.shape == (2, 3, 64, n_pad)
    inverse = np.argsort(tplanes.PERM8).tolist()
    for nat, tr in ((hi, t_hi), (lo, t_lo)):
        undone = tr.reshape(2, 3, 64, n_pad // 8, 8)[..., inverse].reshape(2, 3, 64, n_pad)
        assert undone[..., n:].eq(0).all()
        assert torch.equal(undone[..., :n].transpose(-1, -2), nat)
    assert tplanes.tf32_planes_plain(x, natural=False, transposed=True)[:2] == (None, None)


def test_a_cpu_tensor_takes_the_plain_prepass():
    x = torch.randn(1, 2, 9, 72)
    before = tplanes.tf32_planes.launches
    for got, want in zip(tplanes.tf32_planes(x, transposed=True), tplanes.tf32_planes_plain(x, transposed=True)):
        assert torch.equal(got, want)
    assert tplanes.tf32_planes.launches == before


@pytest.mark.parametrize("n", [4096, 333, 5])
def test_planes_at_head_dim_512_sum_back_and_invert(n):
    """The prepass's planes at the VAE mid block's head dim: 13 zero bits,
    hi + lo within 2^-22 of the operand, and the transposed planes undo to
    the natural ones (zeros past n, PERM8 within each group of 8)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((1, 1, n, 512)).astype(np.float32) * np.exp(rng.uniform(-20, 20, (1, 1, n, 512))).astype(np.float32)
    x = torch.from_numpy(x)
    hi, lo, t_hi, t_lo = tplanes.tf32_planes_plain(x, natural=True, transposed=True)
    for p in (hi, lo, t_hi, t_lo):
        assert (p.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi.double() + lo.double()) - x.double()).abs().le(2.0**-22 * x.double().abs()).all()
    n_pad = tplanes.pad8(n)
    assert t_hi.shape == (1, 1, 512, n_pad)
    inverse = np.argsort(tplanes.PERM8).tolist()
    for nat, tr in ((hi, t_hi), (lo, t_lo)):
        undone = tr.reshape(1, 1, 512, n_pad // 8, 8)[..., inverse].reshape(1, 1, 512, n_pad)
        assert undone[..., n:].eq(0).all()
        assert torch.equal(undone[..., :n].transpose(-1, -2), nat)


# ---------------------------------------------------------------------------
# The kernels' arithmetic, emulated: products of split planes, f32 sums.

def _split_mm(a, b):
    """a @ b as the kernels take it: lo.hi + hi.lo + hi.hi of tf32 planes."""
    ah, al = tplanes.tf32_planes_plain(a)[:2]
    bh, bl = tplanes.tf32_planes_plain(b)[:2]
    return al @ bh + ah @ bl + ah @ bh


def _emulated_forward(q, k, v, mask, scale):
    """(out, lse) of the split-tf32 forward: P split before P.V, normalised after."""
    s = _split_mm(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], tattn.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return _split_mm(p, v) / l, (m + torch.log(l)).squeeze(-1)


def _emulated_backward(q, k, v, mask, o, lse, do, scale):
    """(dq, dk, dv) of the split-tf32 backward kernels, from L and di."""
    nk = k.shape[2]
    dead = (lse < tattn.DEAD_ROW)[..., None]
    p = torch.exp(_split_mm(q, k.transpose(-1, -2)) * scale - lse[..., None])
    if mask is not None:
        p = p.masked_fill(~mask[:, None, None, :], 0.0)
    p = torch.where(dead, torch.full_like(p, 1.0 / nk), p)
    di = (do * o).sum(-1, keepdim=True)
    ds = (p * (_split_mm(do, v.transpose(-1, -2)) - di) * scale).masked_fill(dead, 0.0)
    return _split_mm(ds, k), _split_mm(ds.transpose(-1, -2), q), _split_mm(p.transpose(-1, -2), do)


def _inputs(b, h, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    q, k, do = (rng.standard_normal(s, dtype=np.float32) for s in ((b, h, nq, d), (b, h, nk, d), (b, h, nq, d)))
    v = rng.uniform(-1, 1, (b, h, nk, d)).astype(np.float32)
    return q, k, v, do


CASES = {  # (B, H, Nq, Nk, D, keys kept per sample or None)
    "d64": (2, 2, 200, 256, 64, None),
    "d72_ragged": (1, 2, 130, 77, 72, None),
    "d72_masked_row": (2, 2, 100, 300, 72, [300, 123]),
    "d64_4_keys": (2, 2, 64, 4, 64, None),
    "d64_ragged_masked": (1, 2, 203, 45, 64, [31]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_split_forward_and_vjp_match_jax_flash_interpret(case):
    b, h, nq, nk, d, lens = CASES[case]
    q, k, v, do = _inputs(b, h, nq, nk, d, seed=12)
    mask = None if lens is None else np.arange(nk)[None] < np.asarray(lens)[:, None]
    jmask = None if mask is None else jnp.asarray(mask)
    scale = d**-0.5
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, kv_mask=jmask, block_q=128, block_k=128),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want_grads = vjp(jnp.asarray(do))
        # the forward's emit_lse output on inputs padded to its blocks, the padded keys masked
        pq, pk = -nq % 128, -nk % 128
        keep = np.pad(np.ones((b, nk), bool) if mask is None else mask, ((0, 0), (0, pk)))
        maskf = jnp.repeat(jnp.asarray(keep, jnp.float32)[:, None, :], h, axis=0).reshape(b * h, 1, nk + pk)
        flat = [jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))).reshape(b * h, -1, d)
                for x, pad in ((q, pq), (k, pk), (v, pk))]
        want_lse = jax_flash_fwd_impl(*flat, maskf, scale, True, 128, 128, True)[1][:, :nq]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = _emulated_forward(tq, tk, tv, tmask, scale)
    assert np.abs(o.numpy() - np.asarray(out)).max() <= OUT_BOUND
    assert np.abs(lse.numpy().reshape(b * h, nq) - np.asarray(want_lse)[..., 0]).max() <= LSE_BOUND
    got = _emulated_backward(tq, tk, tv, tmask, o, lse, tdo, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want_grads):
        y = np.asarray(y)
        assert np.abs(x.numpy() - y).max() <= GRAD_REL * np.abs(y).max(), name


@pytest.mark.parametrize("d", [64, 72])
def test_emulated_split_with_a_fully_masked_sample_matches_jax_sdpa_vjp(d):
    """A sample with no real key: the port (and the JAX package's sdpa)
    average V over its Nk keys, and the backward's flag rule (L = -1e30:
    P = 1/Nk, dS = 0) gives the gradient of that mean. The TPU kernel
    averages over its padded key length instead, so jax's sdpa is the
    reference here."""
    b, h, nq, nk = 2, 2, 40, 30
    q, k, v, do = _inputs(b, h, nq, nk, d, seed=d)
    mask = np.arange(nk)[None] < np.asarray([0, 19])[:, None]
    scale = d**-0.5
    out, vjp = jax.vjp(lambda q, k, v: jax_sdpa(q, k, v, kv_mask=jnp.asarray(mask), scale=scale),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = _emulated_forward(tq, tk, tv, torch.from_numpy(mask), scale)
    assert (lse[0] == tattn.NEG_INF).all()
    assert np.abs(o.numpy() - np.asarray(out)).max() <= OUT_BOUND
    got = _emulated_backward(tq, tk, tv, torch.from_numpy(mask), o, lse, tdo, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want_grads):
        y = np.asarray(y)
        assert np.abs(x.numpy() - y).max() <= GRAD_REL * np.abs(y).max(), name
    assert got[0][0].abs().max() == 0 and got[1][0].abs().max() == 0


# ---------------------------------------------------------------------------
# Head dim 512: the forward alone (no backward there), as its kernel computes it.

def _emulated_forward_d512(q, k, v, mask, scale):
    """The head-dim-512 kernel's arithmetic: the split Q.K^T of each half of
    the head dim on its own (one warpgroup each, Q split in registers as the
    prepass splits K) and the halves added; an online softmax over 32-key
    tiles, masked keys at -1e30 from a running max of -1e30; each tile's split
    P.V folded into the running output with the rescale; normalised last."""
    nk, half = k.shape[2], q.shape[-1] // 2
    s = sum(_split_mm(q[..., i:i + half], k[..., i:i + half].transpose(-1, -2)) for i in (0, half)) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], tattn.NEG_INF)
    m = torch.full(s.shape[:-1] + (1,), tattn.NEG_INF)
    l, o = torch.zeros_like(m), torch.zeros(*s.shape[:-1], v.shape[-1])
    for k0 in range(0, nk, 32):
        st = s[..., k0:k0 + 32]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _split_mm(p, v[..., k0:k0 + 32, :])
        m = m_new
    return o / l


def _within_f32_bounds(got, want):
    err = np.abs(got - want).max()
    return err <= min(OUT_BOUND, OUT_REL * np.abs(want).max()), err


D512_CASES = {  # (B, H, Nq, Nk, keys kept per sample or None)
    "ragged": (1, 1, 100, 77, None),
    "ragged_masked_two_samples": (2, 1, 70, 200, [200, 45]),
}


@pytest.mark.parametrize("case", list(D512_CASES))
def test_emulated_split_d512_forward_matches_jax_flash_interpret(case):
    b, h, nq, nk, lens = D512_CASES[case]
    d = 512
    q, k, v, _ = _inputs(b, h, nq, nk, d, seed=512)
    mask = None if lens is None else np.arange(nk)[None] < np.asarray(lens)[:, None]
    scale = d**-0.5
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   kv_mask=None if mask is None else jnp.asarray(mask), block_q=128, block_k=128)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = _emulated_forward_d512(*(torch.from_numpy(x) for x in (q, k, v)), tmask, scale)
    ok, err = _within_f32_bounds(got.numpy(), np.asarray(want))
    assert ok, err


def test_emulated_split_d512_with_a_fully_masked_sample_matches_jax_sdpa():
    """A sample with no real key at head dim 512: the port averages V over
    its Nk keys, as the JAX package's sdpa (the TPU kernel averages over its
    padded key length instead)."""
    b, h, nq, nk, d = 2, 1, 40, 45, 512
    q, k, v, _ = _inputs(b, h, nq, nk, d, seed=7)
    mask = np.arange(nk)[None] < np.asarray([0, 33])[:, None]
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(mask), scale=d**-0.5)
    got = _emulated_forward_d512(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask), d**-0.5)
    ok, err = _within_f32_bounds(got.numpy(), np.asarray(want))
    assert ok, err
    assert torch.allclose(got[0], torch.from_numpy(v[0]).mean(-2, keepdim=True).expand(h, nq, d), atol=1e-6)
