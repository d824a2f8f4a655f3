"""The port's fused GN+SiLU+conv3x3 (its plain version, which the CPU runs)
against the JAX package's Pallas kernel in interpret mode, as
tests/test_gn_conv.py runs it, its gradient against the JAX custom_vjp's,
the split-tf32 weight planes its f32 kernel reads, and the packed-weight
cache of the modules that feed it.

Tolerances. f32: the two sides sum 9C products in other orders; 1e-4 on
outputs of size up to about 8. bf16: both round the activation to bf16, sum in
f32, add the bias in f32 and round the output once; the f32 values differ by
summation order, which can carry an output across a rounding boundary (one
bf16 step, 3.1e-2 at |out| < 8) and an activation across one before the
products: 6.3e-2, two steps.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test worker)

import jax
import jax.numpy as jnp

from instarevive_tpu.ops.gn_conv import _reference as jax_reference
from instarevive_tpu.ops.gn_conv import gn_silu_conv3x3 as jax_gn_silu_conv3x3
from instarevive_tpu_torch.models.vae import ResnetBlock
from instarevive_tpu_torch.ops import cuda_build
from instarevive_tpu_torch.ops import gn_conv as tconv
from instarevive_tpu_torch.ops.tf32_planes import tf32_planes_plain

ATOL = {"float32": 1e-4, "bfloat16": 6.3e-2}


def _mats(n, h, w, c, co, seed=0):
    """tests/test_gn_conv.py's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, c, co)) * 0.05).astype(np.float32)
    bias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    return x, gamma, beta, wk, bias


def _port(mats, dtype):
    x, gamma, beta, wk, bias = (torch.from_numpy(m) for m in mats)
    dt = getattr(torch, dtype)
    return tconv.gn_silu_conv3x3(x.to(dt), gamma, beta, wk.to(dt), bias)


def _jax(mats, dtype, **kw):
    x, gamma, beta, wk, bias = (jnp.asarray(m) for m in mats)
    return jax_gn_silu_conv3x3(x.astype(getattr(jnp, dtype)), gamma, beta, wk, bias, interpret=True, **kw)


@pytest.mark.parametrize(
    "n,h,w,c,co,th",
    [
        (1, 16, 16, 128, 128, 4),   # tests/test_gn_conv.py's stage geometries: first, interior
        (2, 8, 16, 256, 256, 4),    # and last strips, a rectangular image, batch 2
        (1, 8, 8, 512, 512, 4),
        (1, 16, 8, 256, 128, 4),    # a channel-changing conv
        (1, 4, 8, 128, 128, None),  # one strip: both halo rows zero in one program
        (1, 5, 7, 128, 128, None),  # odd H and W
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_pallas_kernel(n, h, w, c, co, th, dtype):
    mats = _mats(n, h, w, c, co)
    ref = _jax(mats, dtype, th=th)
    out = _port(mats, dtype)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == (n, h, w, co) and out.is_contiguous()
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("n,h,w,c,co", [(1, 8, 8, 64, 64), (2, 3, 5, 96, 32)])
def test_channels_the_tpu_kernel_refuses_match_the_jax_composition(n, h, w, c, co):
    """C a multiple of 32 but not of 128: the JAX side is its plain composition
    with a two-pass variance; the port's E[x^2] - mean^2 differs by f32
    cancellation only."""
    mats = _mats(n, h, w, c, co, seed=1)
    ref = jax_reference(*(jnp.asarray(m) for m in mats), groups=32, eps=1e-6)
    np.testing.assert_allclose(_port(mats, "float32").numpy(), np.asarray(ref), atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_is_zero_after_the_silu(dtype):
    """A constant image with beta != 0 normalises to beta everywhere. With
    equal weights an interior output sums 9 taps of silu(beta), an edge 6 and
    a corner 4; a halo of silu(b) in place of zero would make them all 9. The
    JAX kernel agrees at every pixel, the edges included."""
    c, co, beta_value = 128, 128, 1.5
    x = np.full((1, 8, 12, c), 0.5, np.float32)
    mats = (x, np.ones(c, np.float32), np.full(c, beta_value, np.float32),
            np.full((3, 3, c, co), 1.0 / c, np.float32), np.zeros(co, np.float32))
    out = _port(mats, dtype).float().numpy()
    s = float(torch.nn.functional.silu(torch.tensor(beta_value)).to(getattr(torch, dtype)).float())
    for (yy, xx), taps in (((3, 6), 9), ((0, 0), 4), ((7, 11), 4), ((0, 5), 6), ((4, 11), 6), ((4, 0), 6)):
        assert abs(out[0, yy, xx, 0] - taps * s) <= 2e-2 * taps * s, (yy, xx, out[0, yy, xx, 0])
    np.testing.assert_allclose(out, np.asarray(_jax(mats, dtype, th=4), np.float32), atol=ATOL[dtype], rtol=0)


def test_near_constant_input_stays_finite():
    mats = list(_mats(1, 8, 8, 64, 64, seed=2))
    mats[0] = np.full_like(mats[0], 1234.5)
    assert torch.isfinite(_port(mats, "float32")).all()


def test_cpu_wrapper_runs_the_plain_version_without_the_kernel_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA kernel library")

    monkeypatch.setattr(tconv, "load_library", refuse)
    monkeypatch.setattr(cuda_build, "load_library", refuse)
    mats = [torch.from_numpy(m) for m in _mats(1, 6, 6, 64, 32, seed=3)]
    before = tconv.gn_silu_conv3x3.launches
    assert torch.equal(tconv.gn_silu_conv3x3(*mats), tconv.gn_silu_conv3x3_plain(*mats))
    assert tconv.gn_silu_conv3x3.launches == before and "gn_conv" not in cuda_build._loaded


def _seeded_state(block, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) * 0.2 + (1.0 if "norm" in k and k.endswith("weight") else 0.0)
            for k, v in block.state_dict().items()}


@pytest.mark.parametrize("change", ["load_state_dict", "in_place", "dtype_round_trip", "round_trip_without_a_forward"])
def test_packed_weights_follow_the_parameters(change):
    """The HWIO weights and f32 norm vectors are packed once per module and
    must be rebuilt when the parameters change after a forward: the output of
    a block that already ran has to equal a fresh block's with the new
    weights."""
    x = torch.randn(2, 64, 6, 6, generator=torch.Generator().manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last)
    block = ResnetBlock(64, 32).eval().requires_grad_(False)
    block.load_state_dict(_seeded_state(block, 1))
    first = block(x)
    packed = block.conv1.hwio()[0]
    assert block.conv1.hwio()[0] is packed  # one pack, reused
    assert "hwio" not in "".join(block.state_dict().keys()) and len(block.state_dict()) == 10

    new = _seeded_state(block, 2)
    if change == "load_state_dict":
        block.load_state_dict(new)
    elif change == "in_place":
        with torch.no_grad():
            for k, p in block.state_dict().items():
                p.copy_(new[k])
    elif change == "round_trip_without_a_forward":
        # version, dtype and device all come back, and the allocator may hand
        # back the old address: only the conversion itself tells the pack is stale
        block.load_state_dict(new)
        block(x)
        packed = block.conv1.hwio()[0]
        block.to(torch.bfloat16).to(torch.float32)
        assert not block.conv1.__dict__.get("_derived") and not block.norm1.__dict__.get("_derived")
        new = block.state_dict()
        assert not torch.equal(packed, block.conv1.weight.permute(2, 3, 1, 0))  # rounded since
    else:  # through bf16 and back: the values are new (rounded), the packs must follow both moves
        block.load_state_dict(new)
        block.to(torch.bfloat16)
        assert block.conv1.hwio()[0].dtype == torch.bfloat16
        block.to(torch.float32)
        new = block.state_dict()
    fresh = ResnetBlock(64, 32).eval().requires_grad_(False)
    fresh.load_state_dict(new)
    out = block(x)
    assert block.conv1.hwio()[0] is not packed
    assert not torch.allclose(out, first, atol=1e-3)
    torch.testing.assert_close(out, fresh(x), atol=0, rtol=0)


def test_packed_weights_of_a_module_built_in_inference_mode():
    """Parameters made under inference mode carry no version counter; the
    pack is then keyed on dtype, device and storage alone."""
    with torch.inference_mode():
        block = ResnetBlock(32, 32).eval()
        x = torch.randn(1, 32, 4, 4).contiguous(memory_format=torch.channels_last)
        out = block(x)
        assert torch.isfinite(out).all() and block.conv1.hwio()[0] is block.conv1.hwio()[0]


def test_packed_weights_follow_a_reload_in_inference_mode():
    """Inference tensors have no version to bump; ``load_state_dict`` drops
    the packs itself."""
    with torch.inference_mode():
        block = ResnetBlock(32, 32).eval()
        x = torch.randn(1, 32, 4, 4).contiguous(memory_format=torch.channels_last)
        first = block(x)
        new = _seeded_state(block, 4)
        block.load_state_dict(new)
        fresh = ResnetBlock(32, 32).eval()
        fresh.load_state_dict(new)
        out = block(x)
        assert not torch.allclose(out, first, atol=1e-3)
        torch.testing.assert_close(out, fresh(x), atol=0, rtol=0)


@pytest.mark.parametrize("c,co", [(64, 32), (96, 160)])
def test_weight_planes_are_the_split_of_the_ohwi_weight(c, co):
    """What the f32 kernel reads: w (3, 3, C, Co) as hi and lo planes of
    (Co, 3, 3, C), bit for bit the split prepass's plain version of w in OHWI
    order; hi + lo within 2^-22 |w|, each plane's low 13 mantissa bits zero."""
    w = torch.from_numpy(_mats(1, 1, 1, c, co, seed=4)[3]) * 10.0
    hi, lo = tconv.weight_planes(w)
    want_hi, want_lo, _, _ = tf32_planes_plain(w.permute(3, 0, 1, 2).reshape(co, 9, c))
    assert hi.shape == lo.shape == (co, 3, 3, c) and hi.dtype == lo.dtype == torch.float32
    assert hi.is_contiguous() and lo.is_contiguous()
    assert torch.equal(hi.reshape(co, 9, c), want_hi) and torch.equal(lo.reshape(co, 9, c), want_lo)
    ohwi = w.permute(3, 0, 1, 2).double()
    assert ((hi.double() + lo.double() - ohwi).abs() <= 2.0**-22 * ohwi.abs()).all()
    for plane in (hi, lo):
        assert not (plane.view(torch.int32) & 0x1FFF).any()


def test_cpu_wrapper_ignores_the_planes():
    """On the CPU the wrapper runs the plain version whatever planes it is
    handed: the right ones and zeros give the same bits."""
    mats = [torch.from_numpy(m) for m in _mats(2, 5, 7, 64, 32, seed=5)]
    want = tconv.gn_silu_conv3x3_plain(*mats)
    planes = tconv.weight_planes(mats[3])
    assert torch.equal(tconv.gn_silu_conv3x3(*mats, planes=planes), want)
    assert torch.equal(tconv.gn_silu_conv3x3(*mats, 32, 1e-6, tuple(torch.zeros_like(p) for p in planes)), want)


def _jax_grads(mats, cot):
    """All five gradients of <gn_silu_conv3x3(...), cot> through the JAX
    package's custom_vjp (its Pallas kernel forward in interpret mode)."""
    def loss(*args):
        return jnp.sum(jax_gn_silu_conv3x3(*args, interpret=True) * jnp.asarray(cot))

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(m) for m in mats))


def _torch_grads(fn, mats, cot, wanted=range(5)):
    inputs = [torch.from_numpy(m).requires_grad_(i in wanted) for i, m in enumerate(mats)]
    (fn(*inputs) * torch.from_numpy(cot)).sum().backward()
    return [t.grad for t in inputs]


GRAD_ATOL = 1e-4  # f32: both sides differentiate the same composition, summing in other orders


def test_gradients_match_the_jax_custom_vjp():
    """x, gamma, beta, w and bias all require grad: the port's gradients
    (the CPU runs autograd through the plain version) against jax.grad of the
    JAX package's custom_vjp, at 1e-4."""
    mats = _mats(1, 8, 8, 128, 128, seed=6)
    cot = np.random.default_rng(7).standard_normal((1, 8, 8, 128)).astype(np.float32)
    for got, want in zip(_torch_grads(tconv.gn_silu_conv3x3, mats, cot), _jax_grads(mats, cot)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL, rtol=GRAD_ATOL)


# bf16: x and w in bf16, gamma, beta and bias f32. Each side rounds x's and
# w's gradients to bf16 once and sums in f32 in its own order (the port an
# f32 convolution of the bf16 activation, JAX one in bf16), which can carry a
# value across a rounding boundary: two bf16 steps of the largest magnitude,
# 2^-7 of it. gamma's and beta's are f32 sums of the same bf16 terms: the same
# bound. bias's gradient is the sum of the bf16 cotangent over N*H*W pixels;
# the port takes it in f32, JAX in bf16 (the bias is added in x's dtype), so
# JAX is as far from the exact sum as its own bf16 partial sums carry it: the
# bound is that distance, computed here, plus the same two steps.
BF16_GRAD_REL = 2.0**-7


def test_bf16_gradients_match_the_jax_custom_vjp():
    """The five gradients of a bf16 call (x and w bf16) through the port's
    backward against jax.grad of the JAX custom_vjp, at the bounds above."""
    mats = _mats(1, 8, 8, 128, 128, seed=6)
    cot = np.random.default_rng(7).standard_normal((1, 8, 8, 128)).astype(np.float32)
    inputs = [torch.from_numpy(m) for m in mats]
    inputs[0], inputs[3] = inputs[0].to(torch.bfloat16), inputs[3].to(torch.bfloat16)
    inputs = [t.requires_grad_() for t in inputs]
    (tconv.gn_silu_conv3x3(*inputs).float() * torch.from_numpy(cot)).sum().backward()

    def loss(*args):
        return jnp.sum(jax_gn_silu_conv3x3(*args, interpret=True).astype(jnp.float32) * jnp.asarray(cot))

    args = [jnp.asarray(m) for m in mats]
    args[0], args[3] = args[0].astype(jnp.bfloat16), args[3].astype(jnp.bfloat16)
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    assert inputs[0].grad.dtype == inputs[3].grad.dtype == torch.bfloat16
    exact_bias = torch.from_numpy(cot).to(torch.bfloat16).double().sum(dim=(0, 1, 2)).numpy()
    for i, (t, w) in enumerate(zip(inputs, want)):
        got, w = t.grad.double().numpy(), np.asarray(w.astype(jnp.float32), dtype=np.float64)
        limit = BF16_GRAD_REL * np.abs(w).max()
        if i == 4:
            limit += np.abs(w - exact_bias).max()
        assert np.abs(got - w).max() <= limit, ("x", "gamma", "beta", "w", "bias")[i]


@pytest.mark.parametrize("wanted", [range(5), (0, 3)])
def test_autograd_function_backward_matches_the_jax_custom_vjp(monkeypatch, wanted):
    """The card's ``_GnSiluConv3x3``, its kernels' forward stood in for by the
    plain version: its backward gives every input that requires grad (all
    five, or x and w alone) JAX's gradient and the others None."""
    monkeypatch.setattr(tconv, "_forward", lambda x, g, b, w, bias, groups, eps, planes:
                        tconv.gn_silu_conv3x3_plain(x.detach(), g.detach(), b.detach(), w.detach(),
                                                    bias.detach(), groups, eps))

    def fn(x, gamma, beta, w, bias):
        return tconv._GnSiluConv3x3.apply(x, gamma, beta, w, bias, 32, 1e-6, None)

    mats = _mats(1, 8, 8, 128, 128, seed=8)
    cot = np.random.default_rng(9).standard_normal((1, 8, 8, 128)).astype(np.float32)
    got = _torch_grads(fn, mats, cot, wanted)
    for i, want in enumerate(_jax_grads(mats, cot)):
        if i in wanted:
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=GRAD_ATOL, rtol=GRAD_ATOL)
        else:
            assert got[i] is None


@pytest.mark.parametrize("change", ["load_state_dict", "in_place", "dtype_round_trip", "round_trip_without_a_forward"])
def test_weight_planes_follow_the_parameters(change):
    """The split-tf32 planes of the f32 kernel are packed once per module
    (on the card an f32 forward packs them, on the CPU none does) and follow
    the weight as ``hwio()`` does: after each change the cached planes are
    the split of the new weight."""
    x = torch.randn(2, 64, 6, 6, generator=torch.Generator().manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last)
    block = ResnetBlock(64, 32).eval().requires_grad_(False)
    block.load_state_dict(_seeded_state(block, 1))
    block(x)
    assert "tf32_planes" not in block.conv1.__dict__["_derived"]  # the CPU's forward packs none
    packed = block.conv1.tf32_planes()
    assert block.conv1.__dict__["_derived"]["tf32_planes"][1] is packed
    assert block.conv1.tf32_planes() is packed
    new = _seeded_state(block, 2)
    if change == "load_state_dict":
        block.load_state_dict(new)
    elif change == "in_place":
        with torch.no_grad():
            for k, p in block.state_dict().items():
                p.copy_(new[k])
    elif change == "round_trip_without_a_forward":
        block.load_state_dict(new)
        block(x)
        packed = block.conv1.tf32_planes()
        block.to(torch.bfloat16).to(torch.float32)
        assert not block.conv1.__dict__.get("_derived")
    else:
        block.load_state_dict(new)
        block.to(torch.bfloat16)
        block.to(torch.float32)
    block(x)
    planes = block.conv1.tf32_planes()
    assert planes is not packed
    want = tconv.weight_planes(block.conv1.weight.detach().permute(2, 3, 1, 0))
    assert all(torch.equal(p, q) for p, q in zip(planes, want))
    assert not torch.equal(planes[0], packed[0])
