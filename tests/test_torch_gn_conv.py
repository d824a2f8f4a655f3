"""The port's fused GN+SiLU+conv3x3 (its plain version, which the CPU runs)
against the JAX package's Pallas kernel in interpret mode, as
tests/test_gn_conv.py runs it, and the packed-weight cache of the modules
that feed it.

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

import jax.numpy as jnp

from instarevive_tpu.ops.gn_conv import _reference as jax_reference
from instarevive_tpu.ops.gn_conv import gn_silu_conv3x3 as jax_gn_silu_conv3x3
from instarevive_tpu_torch.models.vae import ResnetBlock
from instarevive_tpu_torch.ops import cuda_build
from instarevive_tpu_torch.ops import gn_conv as tconv

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
