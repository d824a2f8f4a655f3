"""The hand-written CUDA kernels of instarevive_tpu_torch against their plain
PyTorch versions on the card. Needs a CUDA device and nvcc, and imports no
JAX, so it runs on a GPU machine without the JAX package's test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a card every test here skips.
"""

import pytest
import torch

from instarevive_tpu_torch.ops.attention import NEG_INF, _forward, flash_attention, flash_lse_plain, sdpa
from instarevive_tpu_torch.ops.filters import filter2d, filter2d_plain
from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain
from instarevive_tpu_torch.ops.norm_kernels import (
    gn_affine, gn_affine_plain, group_norm_silu, group_norm_silu_plain, upsample2x_nearest,
    upsample2x_nearest_plain,
)
from instarevive_tpu_torch.ops import window as W
from instarevive_tpu_torch.ops.swin_attention import swin_window_attention, swin_window_attention_plain
from instarevive_tpu_torch.ops.tf32_planes import tf32_planes, tf32_planes_plain
from instarevive_tpu_torch.pipelines.build import set_precision

# bf16: both outputs rounded to bf16 and P rounded to bf16 before P.V in the
# kernel; f32: summation order, and the split-tf32 products' dropped lo.lo
# term, about 2^-22 of each product (V in [-1, 1], so |out| <= 1).
BOUNDS = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# and a share of the reference's largest magnitude: over thousands of keys
# |out| is near 0.01, where the absolute bound alone would pass a dropped key
# tile. bf16 2e-2 (one bf16 step of the largest value is 3.9e-3 of it); f32
# 1e-4, which products in plain TF32 (near 5e-4 of it) would not meet.
REL_BOUNDS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


# The VAE kernels against their plain versions. Inputs are N(offset, scale^2)
# per channel, so |normalised x| stays under about 5 and, with weights of
# variance 1/(9C), |out| under about 4.
# f32: the kernels and the plain versions sum in other orders; 2e-4.
# bf16 norm: both round one f32 value of size <= 8 to bf16 (spacing 2^-5
# there), and the two f32 values differ by summation order, which can move a
# value across a rounding boundary: one bf16 step, 3.2e-2.
# bf16 conv: as above for the output (|out| < 4: step 1.6e-2), plus the few
# activations among 9C that the two versions round to neighbouring bf16
# values before the products; 4e-2.
NORM_BOUNDS = {torch.bfloat16: 3.2e-2, torch.float32: 2e-4}
CONV_BOUNDS = {torch.bfloat16: 4e-2, torch.float32: 2e-4}


# Window attention against its plain version, v in [-1, 1] so |out| <= 1.
# bf16: both round one f32 value to bf16, and the two f32 values differ by
# summation order only (the kernel keeps 16 bits of P), so at most one bf16
# step below 1, 2^-8; f32: summation order, 1e-5.
SWIN_BOUNDS = {torch.bfloat16: 4e-3, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_precision()  # the plain versions' f32 convolutions stay out of TF32
    return torch.device("cuda")


def _vae_inputs(cuda, dtype, n, h, w, c, co=None, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    offset = torch.randn(c, device=cuda, generator=gen)
    scale = torch.rand(c, device=cuda, generator=gen) + 0.5
    x = (torch.randn(n, h, w, c, device=cuda, generator=gen) * scale + offset).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, device=cuda, generator=gen)
    beta = 0.1 * torch.randn(c, device=cuda, generator=gen)
    if co is None:
        return x, gamma, beta
    wk = (torch.randn(3, 3, c, co, device=cuda, generator=gen) * (9 * c) ** -0.5).to(dtype)
    bias = 0.1 * torch.randn(co, device=cuda, generator=gen)
    return x, gamma, beta, wk, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,h,nq,nk,d,lens",
    [
        (2, 16, 1024, 1024, 72, None),
        (2, 16, 1024, 300, 72, [300, 0]),  # ragged keys, one fully masked row
        (1, 3, 70, 45, 72, [13]),
        (1, 16, 1000, 77, 72, [50]),  # ragged queries and keys, masked
        (1, 16, 1000, 333, 72, None),
        (2, 1, 4096, 4096, 512, None),
        (1, 1, 33, 100, 512, [57]),
        # head dim 512 at the edges of its 64-row blocks and 32-key tiles
        (1, 1, 100, 77, 512, None),          # Nq, Nk multiples of neither
        (1, 2, 129, 1000, 512, [999]),       # one query past two blocks, ragged last key tile, masked
        (1, 1, 70, 20, 512, None),           # Nk under one key tile
        (1, 1, 64, 5, 512, [3]),             # a few keys, masked
        (2, 1, 130, 333, 512, [333, 0]),     # one sample's keys all masked
        (2, 1, 200, 333, 512, [100, 37]),    # batch 2 with different masks
        # head dim 64: every UNet / ControlNet shape of configs/cldm.yaml at batch 2, 512x512 crops
        (2, 5, 4096, 4096, 64, None),
        (2, 5, 4096, 4, 64, None),
        (2, 5, 4096, 77, 64, [77, 30]),
        (2, 10, 1024, 1024, 64, None),
        (2, 10, 1024, 4, 64, None),
        (2, 20, 256, 256, 64, None),
        (2, 20, 256, 4, 64, None),
        (2, 20, 64, 64, 64, None),
        (2, 20, 64, 4, 64, [4, 0]),  # the middle block over 4 keys, one sample with none
        (1, 5, 1000, 40, 64, [33]),  # ragged queries, keys under one key tile, masked
    ],
)
def test_flash_attention_matches_sdpa(cuda, dtype, b, h, nq, nk, d, lens):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, h, nq, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(b, h, nk, d, device=cuda, generator=gen).to(dtype)
    v = (torch.rand(b, h, nk, d, device=cuda, generator=gen) * 2 - 1).to(dtype)
    mask = None
    if lens is not None:
        mask = torch.arange(nk, device=cuda)[None] < torch.tensor(lens, device=cuda)[:, None]
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = sdpa(q, k, v, kv_mask=mask).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= min(BOUNDS[dtype], REL_BOUNDS[dtype] * ref.abs().max().item())


@pytest.mark.cuda
def test_flash_attention_d512_repeats_its_bits(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, nq, nk, d = 2, 1000, 333, 512
    q = torch.randn(b, 1, nq, d, device=cuda, generator=gen).bfloat16()
    k = torch.randn(b, 1, nk, d, device=cuda, generator=gen).bfloat16()
    v = (torch.rand(b, 1, nk, d, device=cuda, generator=gen) * 2 - 1).bfloat16()
    mask = torch.arange(nk, device=cuda)[None] < torch.tensor([199, 0], device=cuda)[:, None]
    first = flash_attention(q, k, v, kv_mask=mask)
    second = flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ref = sdpa(q, k, v, kv_mask=mask).float()
    err = (first.float() - ref).abs().max().item()
    assert err <= min(BOUNDS[torch.bfloat16], REL_BOUNDS[torch.bfloat16] * ref.abs().max().item())


@pytest.mark.cuda
def test_flash_attention_f32_d512_repeats_its_bits(cuda):
    """The split-tf32 form at head dim 512: one forward launch behind two
    prepass launches (K natural, V transposed; Q goes raw), the same bits
    twice, a sample whose keys are all masked averaging V."""
    from instarevive_tpu_torch.ops import attention as A

    gen = torch.Generator(device=cuda).manual_seed(1)
    b, nq, nk, d = 2, 1000, 333, 512
    q = torch.randn(b, 1, nq, d, device=cuda, generator=gen)
    k = torch.randn(b, 1, nk, d, device=cuda, generator=gen)
    v = torch.rand(b, 1, nk, d, device=cuda, generator=gen) * 2 - 1
    mask = torch.arange(nk, device=cuda)[None] < torch.tensor([199, 0], device=cuda)[:, None]
    fwd, planes = A.flash_attention.launches, A.tf32_planes.launches
    first = flash_attention(q, k, v, kv_mask=mask)
    assert (A.flash_attention.launches, A.tf32_planes.launches) == (fwd + 1, planes + 2)
    second = flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ref = sdpa(q, k, v, kv_mask=mask)
    err = (first - ref).abs().max().item()
    assert err <= min(BOUNDS[torch.float32], REL_BOUNDS[torch.float32] * ref.abs().max().item())
    assert (first[1] - v[1].mean(-2, keepdim=True)).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_flash_attention_forward_library_builds_without_a_spill(cuda, tmp_path):
    """ptxas's resource lines for every kernel of csrc/flash_attn_fwd.cu,
    compiled afresh with the port's flags: the bf16 head-dim-512 kernel and
    every f32 form (split-tf32 at 32, 64, 72 and 512) spill nothing."""
    import re
    import subprocess

    from instarevive_tpu_torch.ops import cuda_build

    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(tmp_path / "lib.so"),
           str(cuda_build.CSRC_DIR / "flash_attn_fwd.cu")]
    log = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True).stdout
    kernels = re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S)
    checked = {name: int(re.search(r"(\d+) bytes spill stores", body).group(1)) for name, body in kernels
               if re.search(r"d5126kernel|fwd_tf326kernel|d512_tf326kernel", name)}
    assert len(checked) == 5 and any("d512_tf32" in name for name in checked)
    assert not any(checked.values()), checked


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72])
def test_flash_attention_reads_views_at_an_offset(cuda, d):
    """q, k and v as contiguous views at 16-byte-aligned offsets into one
    buffer of NaNs: the kernel reads them in place (no copy) and reads no
    element outside them, past the last key or head dim included."""
    b, h, nq, nk = 2, 3, 200, 77
    gen = torch.Generator(device=cuda).manual_seed(1)
    sizes = [b * h * n * d for n in (nq, nk, nk)]
    buf = torch.full((sum(sizes) + 3 * 64,), float("nan"), device=cuda, dtype=torch.bfloat16)
    views, at = [], 24  # elements: 48 bytes past the buffer's start, a multiple of 16
    for n, size in zip((nq, nk, nk), sizes):
        t = buf[at:at + size].view(b, h, n, d)
        t.copy_(torch.rand(b, h, n, d, device=cuda, generator=gen) * 2 - 1)
        views.append(t)
        at += size + 64
    q, k, v = views
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 and t.data_ptr() != buf.data_ptr() for t in views)
    mask = torch.arange(nk, device=cuda)[None] < torch.tensor([nk, 30], device=cuda)[:, None]
    out = flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out.float() - sdpa(q, k, v, kv_mask=mask).float()).abs().max().item()
    assert err <= BOUNDS[torch.bfloat16]


# The row log-sum-exp (about log Nk + 0.5 here) is f32 in both versions; the
# kernel works in the log2 domain (ex2.approx, log2f); 1e-3.
LSE_BOUND = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72])
def test_flash_forward_lse_matches_plain(cuda, d):
    """The bf16 forward's log-sum-exp against flash_lse_plain; a sample
    whose keys are all masked gets exactly -1e30, the backward's flag."""
    b, h, nq, nk = 2, 4, 200, 150
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k = (torch.randn(b, h, n, d, device=cuda, generator=gen).to(torch.bfloat16) for n in (nq, nk))
    v = (torch.rand(b, h, nk, d, device=cuda, generator=gen) * 2 - 1).to(torch.bfloat16)
    mask = torch.arange(nk, device=cuda)[None] < torch.tensor([0, 97], device=cuda)[:, None]
    out, lse = _forward(q, k, v, mask, d**-0.5, want_lse=True)
    torch.cuda.synchronize()
    assert (lse - flash_lse_plain(q, k, mask, d**-0.5)).abs().max().item() <= LSE_BOUND
    assert torch.all(lse[0] == NEG_INF)
    assert (out.float() - sdpa(q, k, v, kv_mask=mask).float()).abs().max().item() <= BOUNDS[torch.bfloat16]


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_cannot_run(cuda):
    q = torch.randn(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    # head dim 512 has a backward kernel in f32 only
    q = torch.randn(1, 1, 8, 512, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q, q)
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape


# The backward kernels against flash_backward_plain on the same q, k, v, o,
# lse, dO, per output relative to its largest magnitude. bf16: both round P,
# dS and the output to bf16 at the same places, and a sum taken in another
# order can cross a rounding boundary (one bf16 step, 2^-8, of the largest
# value); f32: the order of the sums, ex2 against exp, and the split-tf32
# products' dropped lo.lo term, about 2^-22 of each product.
BACKWARD_BOUNDS = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


def _backward_inputs(cuda, dtype, b, h, nq, nk, d, lens, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, n, d, device=cuda, generator=gen).to(dtype) for n in (nq, nk, nk, nq))
    mask = None if lens is None else torch.arange(nk, device=cuda)[None] < torch.tensor(lens, device=cuda)[:, None]
    return q, k, v, do, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,h,nq,nk,lens,d",
    [
        (2, 16, 1024, 1024, None, 72),
        (2, 16, 1024, 300, [77, 300], 72),
        (2, 4, 256, 300, [0, 120], 72),  # a sample with every key masked
        (1, 16, 1000, 77, None, 72),     # ragged
        (1, 3, 70, 45, [13], 72),
        (1, 2, 5, 3, None, 72),
        # head dim 64: the shapes of the UNet's decoder and the ControlNet that take a gradient
        (2, 5, 4096, 4096, None, 64),
        (2, 5, 4096, 4, None, 64),
        (2, 5, 4096, 77, [77, 20], 64),
        (2, 10, 1024, 1024, None, 64),
        (2, 20, 256, 256, None, 64),
        (2, 20, 64, 64, None, 64),
        (2, 20, 64, 4, [4, 0], 64),
        (1, 3, 70, 45, [13], 64),
    ],
)
def test_flash_backward_matches_plain_and_repeats_bitwise(cuda, dtype, b, h, nq, nk, lens, d):
    from instarevive_tpu_torch.ops import attention as A

    q, k, v, do, mask = _backward_inputs(cuda, dtype, b, h, nq, nk, d, lens)
    scale = d**-0.5
    out, lse = A._forward(q, k, v, mask, scale, want_lse=True)
    torch.cuda.synchronize()
    want_lse = A.flash_lse_plain(q, k, mask, scale)
    assert (lse - want_lse).abs().max().item() <= 1e-3
    ref = sdpa(q, k, v, kv_mask=mask, scale=scale).float()  # v is N(0, 1) here: the bound scales with |out|
    assert (out.float() - ref).abs().max().item() <= BOUNDS[dtype] * max(1.0, ref.abs().max().item())
    before = (A.flash_dq.launches, A.flash_dkv.launches)
    got = A.flash_backward(q, k, v, mask, out, lse, do, scale)
    torch.cuda.synchronize()
    assert (A.flash_dq.launches, A.flash_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = A.flash_backward_plain(q, k, v, mask, out, lse, do, scale)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b_.shape and torch.isfinite(a).all(), name
        assert (a.float() - b_.float()).abs().max().item() <= BACKWARD_BOUNDS[dtype] * b_.float().abs().max().item(), name
    again = A.flash_backward(q, k, v, mask, out, lse, do, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,nq,nk,lens,d",
    [
        (1, 16, 1000, 77, None, 72),    # ragged Nq and Nk, each one partial tile; the head-dim 64-79 tail
        (1, 16, 1000, 77, [50], 64),    # the same at 64 with masked keys
        (2, 5, 4096, 4, None, 64),      # the UNet's 4-key context: one dk/dv block walks 4096 queries
        (2, 16, 256, 4, None, 72),      # 4 keys under the tail
        (2, 4, 300, 77, [0, 77], 72),   # a sample whose keys are all masked
        (2, 4, 130, 300, [300, 0], 64),
    ],
)
def test_flash_backward_bf16_edges(cuda, b, h, nq, nk, lens, d):
    """The bf16 wgmma body at its edges, against flash_backward_plain (v in
    [-1, 1], as chip_smoke.py) at chip_smoke.py's bound: 1e-2 of each
    output's largest magnitude; dq of a sample with no key is exactly 0 (dS =
    0 there); the same bits twice; and the same call on views of the same
    storage at a second, shorter Nq (a tensor map cached for the first shape
    at that address must not serve the second)."""
    from instarevive_tpu_torch.ops import attention as A

    q, k, v, do, mask = _backward_inputs(cuda, torch.bfloat16, b, h, nq, nk, d, lens, seed=3)
    v = (v.float().tanh()).to(torch.bfloat16)
    scale = d**-0.5
    for n in (nq, nq - 37):
        qn, don = (t.flatten()[: b * h * n * d].view(b, h, n, d) for t in (q, do))
        out, lse = A._forward(qn, k, v, mask, scale, want_lse=True)
        before = (A.flash_dq.launches, A.flash_dkv.launches)
        got = A.flash_backward(qn, k, v, mask, out, lse, don, scale)
        torch.cuda.synchronize()
        assert (A.flash_dq.launches, A.flash_dkv.launches) == (before[0] + 1, before[1] + 1)
        want = A.flash_backward_plain(qn, k, v, mask, out, lse, don, scale)
        for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == b_.shape and torch.isfinite(a).all(), name
            bound = BACKWARD_BOUNDS[torch.bfloat16] * b_.float().abs().max().item()
            assert (a.float() - b_.float()).abs().max().item() <= bound, (name, n)
        if lens is not None and 0 in lens:
            assert not got[0][lens.index(0)].any()
        assert all(torch.equal(x, y) for x, y in zip(got, A.flash_backward(qn, k, v, mask, out, lse, don, scale)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 1024, 72), (1, 16, 77, 72), (2, 5, 4096, 64), (1, 3, 5, 64), (3, 1, 300, 72),
                                   (2, 1, 4096, 512), (1, 2, 333, 512)])
def test_tf32_planes_match_plain_bit_for_bit(cuda, shape):
    """The prepass against tf32_planes_plain by torch.equal, natural and
    transposed planes (ragged n: the padding and the order within groups of
    8), on values over many binades, ties included."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, device=cuda, generator=gen) * torch.exp(torch.randn(shape, device=cuda, generator=gen) * 8)
    x.view(-1)[:64] = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11] * 21 + [0.0], device=cuda)
    before = tf32_planes.launches
    for natural, transposed in ((True, False), (False, True), (True, True)):
        got = tf32_planes(x, natural, transposed)
        want = tf32_planes_plain(x, natural, transposed)
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))
    assert tf32_planes.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,nq,nk,lens,d",
    [
        (1, 16, 1000, 77, None, 72),    # ragged Nq and Nk, each one partial tile; head dims 64-71 in their own box
        (1, 16, 1000, 77, [50], 64),    # the same at 64 with masked keys
        (2, 5, 4096, 4, None, 64),      # the UNet's 4-key context: one dk/dv block walks 4096 queries
        (2, 16, 256, 4, None, 72),      # 4 keys: half of one 8-key group of the transposed planes
        (2, 4, 300, 77, [0, 77], 72),   # a sample whose keys are all masked
        (2, 4, 130, 300, [300, 0], 64),
    ],
)
def test_flash_f32_edges(cuda, b, h, nq, nk, lens, d):
    """The split-tf32 forms of K1 and K2 at their edges: the output against
    sdpa (1e-4), the log-sum-exp against flash_lse_plain (1e-4; exactly -1e30
    for a sample with no key), the same output bits with and without it, the
    gradients against flash_backward_plain (2e-5 of each one's largest
    magnitude; dq of a sample with no key exactly 0), the same bits twice,
    one forward launch and three prepass launches a forward, and the same
    calls on views of the same storage at a second, shorter Nq (a tensor map
    cached for the first shape at that address must not serve the second)."""
    from instarevive_tpu_torch.ops import attention as A

    q, k, v, do, mask = _backward_inputs(cuda, torch.float32, b, h, nq, nk, d, lens, seed=4)
    v = v.tanh()
    scale = d**-0.5
    for n in (nq, nq - 37):
        qn, don = (t.flatten()[: b * h * n * d].view(b, h, n, d) for t in (q, do))
        fwd, planes = A.flash_attention.launches, A.tf32_planes.launches
        out, lse = A._forward(qn, k, v, mask, scale, want_lse=True)
        assert (A.flash_attention.launches, A.tf32_planes.launches) == (fwd + 1, planes + 3)
        torch.cuda.synchronize()
        assert torch.equal(out, A._forward(qn, k, v, mask, scale, want_lse=False)[0])
        assert (out - sdpa(qn, k, v, kv_mask=mask, scale=scale)).abs().max().item() <= BOUNDS[torch.float32]
        assert (lse - flash_lse_plain(qn, k, mask, scale)).abs().max().item() <= 1e-4
        if lens is not None and 0 in lens:
            assert torch.all(lse[lens.index(0)] == NEG_INF)
        before = (A.flash_dq.launches, A.flash_dkv.launches)
        got = A.flash_backward(qn, k, v, mask, out, lse, don, scale)
        torch.cuda.synchronize()
        assert (A.flash_dq.launches, A.flash_dkv.launches) == (before[0] + 1, before[1] + 1)
        want = A.flash_backward_plain(qn, k, v, mask, out, lse, don, scale)
        for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == torch.float32 and a.shape == b_.shape and torch.isfinite(a).all(), name
            bound = BACKWARD_BOUNDS[torch.float32] * b_.abs().max().item()
            assert (a - b_).abs().max().item() <= bound, (name, n)
        if lens is not None and 0 in lens:
            assert not got[0][lens.index(0)].any()
        assert all(torch.equal(x, y) for x, y in zip(got, A.flash_backward(qn, k, v, mask, out, lse, don, scale)))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,nq,nk,lens",
    [
        (64, 4, 64, 64, None),          # the toy DiT's self-attention (tools/train_validation.py at its defaults)
        (64, 4, 64, 4, None),           # its cross-attention over 4 zero caption keys: one dk/dv block a head
        (3, 4, 77, 45, [13, 45, 0]),    # ragged Nq and Nk, masked keys, a sample whose keys are all masked
    ],
)
def test_flash_f32_head_dim_32_matches_plain(cuda, b, h, nq, nk, lens):
    """K1's f32 form at head dim 32 without and with the log-sum-exp, and
    K2's f32 dq and dk/dv passes, against sdpa, flash_lse_plain and
    flash_backward_plain under the f32 bounds of head dims 64 and 72; the same
    bits twice; a launch of each kernel a call."""
    from instarevive_tpu_torch.ops import attention as A

    d = 32
    q, k, v, do, mask = _backward_inputs(cuda, torch.float32, b, h, nq, nk, d, lens, seed=32)
    v = v.tanh()
    scale = d**-0.5
    fwd = A.flash_attention.launches
    plain = A._forward(q, k, v, mask, scale, want_lse=False)[0]
    out, lse = A._forward(q, k, v, mask, scale, want_lse=True)
    assert A.flash_attention.launches == fwd + 2
    torch.cuda.synchronize()
    ref = sdpa(q, k, v, kv_mask=mask, scale=scale)
    assert torch.equal(out, plain)
    assert (out - ref).abs().max().item() <= min(BOUNDS[torch.float32], REL_BOUNDS[torch.float32] * ref.abs().max().item())
    assert (lse - flash_lse_plain(q, k, mask, scale)).abs().max().item() <= 1e-4
    if lens is not None and 0 in lens:
        assert torch.all(lse[lens.index(0)] == NEG_INF)
    before = (A.flash_dq.launches, A.flash_dkv.launches)
    got = A.flash_backward(q, k, v, mask, out, lse, do, scale)
    torch.cuda.synchronize()
    assert (A.flash_dq.launches, A.flash_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = A.flash_backward_plain(q, k, v, mask, out, lse, do, scale)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b_.shape and torch.isfinite(a).all(), name
        assert (a - b_).abs().max().item() <= BACKWARD_BOUNDS[torch.float32] * b_.abs().max().item(), name
    assert all(torch.equal(x, y) for x, y in zip(got, A.flash_backward(q, k, v, mask, out, lse, do, scale)))


@pytest.mark.cuda
def test_flash_attention_head_dim_32_is_f32_only(cuda):
    """Head dim 32 has f32 kernels only: bf16 raises, naming its dtype, in
    the forward and in the backward; nothing falls back to sdpa."""
    from instarevive_tpu_torch.ops import attention as A

    q = torch.randn(2, 4, 64, 32, device=cuda, dtype=torch.bfloat16)
    fwd = A.flash_attention.launches
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bfloat16"):
        A.attention(q, q, q)
    lse = torch.zeros(2, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        A.flash_dq(q, q, q, None, lse, lse, q, 32**-0.5)
    assert A.flash_attention.launches == fwd
    qf = q.float().requires_grad_(True)
    out = flash_attention(qf, qf, qf)  # f32 takes a gradient at 32
    assert A.flash_attention.launches == fwd + 1
    (grad,) = torch.autograd.grad(out.sum(), qf)
    assert torch.isfinite(grad).all()


# The frozen VAE's mid block under a gradient (the Reflow trainer's LPIPS term through the decode): the decode at
# 512^2 batch 2, and a ragged shape whose second sample has every key masked (chip_smoke.py phase 20)
D512_GRAD_CASES = {"vae_mid_decode_b2": (2, 4096, 4096, None), "ragged_one_sample_fully_masked": (2, 1000, 333, [199, 0])}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(D512_GRAD_CASES))
def test_flash_f32_head_dim_512_backward_matches_plain_and_repeats_bitwise(cuda, case):
    """K2's f32 form at head dim 512 (dq; dK and dV in one grid) against
    flash_backward_plain at K2's f32 bound, 2e-5 of each output's largest
    magnitude (v in [-1, 1], as chip_smoke.py); K1's log-sum-exp at 512
    against flash_lse_plain (1e-4), exactly -1e30 for a sample with no key;
    one dq and one dk/dv launch behind four prepass launches; the same bits
    twice."""
    from instarevive_tpu_torch.ops import attention as A

    b, nq, nk, lens = D512_GRAD_CASES[case]
    d, scale = 512, 512**-0.5
    q, k, v, do, mask = _backward_inputs(cuda, torch.float32, b, 1, nq, nk, d, lens, seed=5)
    v = v.clamp(-1, 1)
    out, lse = A._forward(q, k, v, mask, scale, want_lse=True)
    torch.cuda.synchronize()
    assert (lse - A.flash_lse_plain(q, k, mask, scale)).abs().max().item() <= 1e-4
    if lens is not None:
        assert torch.all(lse[lens.index(0)] == NEG_INF)
    before = (A.flash_dq.launches, A.flash_dkv.launches, A.tf32_planes.launches)
    got = A.flash_backward(q, k, v, mask, out, lse, do, scale)
    torch.cuda.synchronize()
    assert (A.flash_dq.launches, A.flash_dkv.launches, A.tf32_planes.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 4)
    want = A.flash_backward_plain(q, k, v, mask, out, lse, do, scale)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b_.shape and torch.isfinite(a).all(), name
        assert (a - b_).abs().max().item() <= BACKWARD_BOUNDS[torch.float32] * b_.abs().max().item(), name
    again = A.flash_backward(q, k, v, mask, out, lse, do, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_flash_attention_head_dim_512_takes_a_gradient_in_f32_only(cuda):
    """f32 at head dim 512 goes through the autograd.Function (K1 with its
    log-sum-exp, then dq and dk/dv) and agrees with autograd through sdpa;
    bf16 that requires grad raises, naming its dtype, and launches nothing."""
    from instarevive_tpu_torch.ops import attention as A

    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn(2, 1, n, 512, device=cuda, generator=gen) for n in (300, 200, 200, 300))
    fwd, dq, dkv = A.flash_attention.launches, A.flash_dq.launches, A.flash_dkv.launches
    with pytest.raises(RuntimeError, match="bfloat16"):
        flash_attention(*(t.bfloat16().requires_grad_(True) for t in (q, k, v)))
    assert A.flash_attention.launches == fwd

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, do)

    got = grads(flash_attention)
    assert (A.flash_attention.launches, A.flash_dq.launches, A.flash_dkv.launches) == (fwd + 1, dq + 1, dkv + 1)
    for a, b_ in zip(got, grads(sdpa)):
        assert (a - b_).abs().max().item() <= 2e-5 * b_.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72])
def test_flash_attention_f32_and_bf16_at_one_address(cuda, d):
    """One storage read as f32 and as bf16 q, k, v in turns: each call gets
    tensor maps of its own element type (the map cache keys the type too)."""
    b, h, n = 1, 2, 256
    gen = torch.Generator(device=cuda).manual_seed(6)
    buf = torch.empty(3 * b * h * n * d, device=cuda)
    for _ in range(2):
        for dtype in (torch.float32, torch.bfloat16):
            x = buf.view(dtype)[: 3 * b * h * n * d].view(3, b, h, n, d)
            x.copy_(torch.rand(3, b, h, n, d, device=cuda, generator=gen) * 2 - 1)
            q, k, v = x.unbind(0)
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            assert q.data_ptr() == buf.data_ptr()
            assert (out.float() - sdpa(q, k, v).float()).abs().max().item() <= BOUNDS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72])
@pytest.mark.parametrize("lens", [None, [0, 120]], ids=["unmasked", "one_sample_fully_masked"])
def test_flash_attention_autograd_matches_autograd_through_sdpa(cuda, lens, d):
    """f32, through the autograd.Function and through non-contiguous head
    views as the DiT and the UNet make them."""
    from instarevive_tpu_torch.ops import attention as A

    b, h, nq, nk = 2, 4, 130, 300
    gen = torch.Generator(device=cuda).manual_seed(1)
    x, y = torch.randn(b, nq, h * d, device=cuda, generator=gen), torch.randn(b, nk, 2 * h * d, device=cuda, generator=gen)
    do = torch.randn(b, h, nq, d, device=cuda, generator=gen)
    mask = None if lens is None else torch.arange(nk, device=cuda)[None] < torch.tensor(lens, device=cuda)[:, None]

    def grads(fn):
        xl, yl = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        k, v = yl.chunk(2, dim=-1)
        heads = lambda t: t.reshape(b, -1, h, d).transpose(1, 2)  # noqa: E731
        return torch.autograd.grad(fn(heads(xl), heads(k), heads(v), kv_mask=mask), (xl, yl), do)

    fwd, dq, dkv = A.flash_attention.launches, A.flash_dq.launches, A.flash_dkv.launches
    got = grads(A.flash_attention)
    assert (A.flash_attention.launches, A.flash_dq.launches, A.flash_dkv.launches) == (fwd + 1, dq + 1, dkv + 1)
    for a, b_ in zip(got, grads(sdpa)):
        assert (a - b_).abs().max().item() <= 2e-5 * b_.abs().max().item()


@pytest.mark.cuda
def test_checkpointed_dit_launches_the_forward_kernel_twice_and_keeps_its_gradients(cuda):
    from instarevive_tpu_torch.models.pixart import PixArt
    from instarevive_tpu_torch.ops import attention as A

    cfg = dict(input_size=16, hidden_size=144, depth=2, num_heads=2, caption_channels=32, model_max_length=8, mlp_ratio=2.0)
    plain = PixArt(**cfg).to(cuda)
    remat = PixArt(**cfg, grad_checkpoint=True).to(cuda)
    remat.load_state_dict(plain.state_dict())
    z, y = torch.randn(2, 16, 16, 4, device=cuda), torch.randn(2, 8, 32, device=cuda)
    t = torch.tensor([400.0, 3.0], device=cuda)
    counts, grads = [], []
    for model in (plain, remat):
        A.flash_attention.launches = A.flash_dq.launches = A.flash_dkv.launches = 0
        grads.append(torch.autograd.grad(model(z, t, y).pow(2).mean(), list(model.parameters())))
        counts.append((A.flash_attention.launches, A.flash_dq.launches, A.flash_dkv.launches))
    assert counts == [(4, 4, 4), (8, 4, 4)]  # two attentions a block; the recomputed forward launches K1 again
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)  # the kernels give the same bits on the same inputs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("n,h,w,c", [(2, 64, 64, 512), (1, 37, 53, 96), (3, 2, 3, 32), (1, 300, 200, 1024)])
def test_group_norm_silu_matches_plain(cuda, dtype, silu, n, h, w, c):
    x, gamma, beta = _vae_inputs(cuda, dtype, n, h, w, c)
    stats, applies = gn_affine.launches, group_norm_silu.launches
    a, b = gn_affine(x, gamma, beta)
    out = group_norm_silu(x, gamma, beta, silu=silu)
    torch.cuda.synchronize()
    assert (gn_affine.launches, group_norm_silu.launches) == (stats + 2, applies + 1)
    a_ref, b_ref = gn_affine_plain(x, gamma, beta)
    torch.testing.assert_close(a, a_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(b, b_ref, atol=1e-5, rtol=1e-5)
    ref = group_norm_silu_plain(x, gamma, beta, silu=silu)
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= NORM_BOUNDS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("n,h,w,c", [(2, 64, 64, 512), (2, 512, 512, 128)])  # the 512^2 decode's AttnBlock, norm_out
def test_group_norm_silu_with_grad_is_kernels_forward_plain_backward(cuda, dtype, silu, n, h, w, c):
    """An input that requires grad: the moments, fold and apply kernels
    forward (the bits of the call without grad), the plain composition's
    input gradient backward; a gamma that requires grad still raises."""
    x, gamma, beta = _vae_inputs(cuda, dtype, n, h, w, c)
    leaf = x.clone().requires_grad_(True)
    stats, applies = gn_affine.launches, group_norm_silu.launches
    out = group_norm_silu(leaf, gamma, beta, silu=silu)
    assert (gn_affine.launches, group_norm_silu.launches) == (stats + 1, applies + 1)
    with torch.no_grad():
        assert torch.equal(out, group_norm_silu(x, gamma, beta, silu=silu))
    grad = torch.randn_like(out)
    (got,) = torch.autograd.grad(out, leaf, grad)
    (want,) = torch.autograd.grad(group_norm_silu_plain(leaf, gamma, beta, silu=silu), leaf, grad)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 1e-6 * want.float().abs().max().item()
    with pytest.raises(RuntimeError, match="no backward"):
        group_norm_silu(leaf, gamma.clone().requires_grad_(True), beta)


@pytest.mark.cuda
def test_gn_affine_is_finite_on_a_constant_input_and_repeats(cuda):
    x = torch.full((1, 64, 64, 64), 3.1415927, device=cuda)
    a, b = gn_affine(x, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    x, gamma, beta = _vae_inputs(cuda, torch.bfloat16, 1, 256, 256, 128)
    first = gn_affine(x, gamma, beta)
    for _ in range(3):  # no atomics: bit-equal from run to run
        again = gn_affine(x, gamma, beta)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.int32])
@pytest.mark.parametrize("n,h,w,c", [(2, 64, 64, 512), (1, 5, 7, 32), (1, 1, 1, 8)])
def test_upsample2x_matches_plain(cuda, dtype, n, h, w, c):
    x = (torch.randn(n, h, w, c, device=cuda) * 100).to(dtype)
    before = upsample2x_nearest.launches
    out = upsample2x_nearest(x)
    torch.cuda.synchronize()
    assert upsample2x_nearest.launches == before + 1
    assert torch.equal(out, upsample2x_nearest_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "n,h,w,c,co",
    [
        (2, 64, 64, 512, 512),
        (1, 72, 72, 256, 128),   # the 576 tile's latent size: ragged against the 16 x 16 pixel tile
        (2, 9, 21, 128, 256),    # odd H and W
        (1, 1, 1, 32, 32),
        (1, 3, 40, 96, 96),      # C, Co multiples of 32 only: the 64-wide channel tile, ragged
        (1, 16, 16, 64, 160),
        (1, 72, 72, 512, 512),   # tile decode at batch 1: the 64-wide channel tile fills the card
        (1, 144, 144, 512, 512),
        (3, 31, 47, 128, 128),   # H and W one short of and past multiples of 16
        (1, 17, 33, 32, 64),     # C = 32: half a 64-channel chunk, the rest zero-filled
        (1, 40, 24, 96, 96),     # C = 96: a whole chunk and half of one; Co = 96 in 64-wide tiles
    ],
)
def test_gn_silu_conv3x3_matches_plain(cuda, dtype, n, h, w, c, co):
    x, gamma, beta, wk, bias = _vae_inputs(cuda, dtype, n, h, w, c, co)
    convs, stats = gn_silu_conv3x3.launches, gn_affine.launches
    out = gn_silu_conv3x3(x, gamma, beta, wk, bias)
    torch.cuda.synchronize()
    assert (gn_silu_conv3x3.launches, gn_affine.launches) == (convs + 1, stats + 1)
    ref = gn_silu_conv3x3_plain(x, gamma, beta, wk, bias)
    assert out.dtype == dtype and out.shape == (n, h, w, co) and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= CONV_BOUNDS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_silu_conv3x3_repeats_its_bits(cuda, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    x, gamma, beta, wk, bias = _vae_inputs(cuda, dtype, 2, 40, 56, 256, 256, seed=4)
    first = gn_silu_conv3x3(x, gamma, beta, wk, bias)
    second = gn_silu_conv3x3(x, gamma, beta, wk, bias)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_silu_conv3x3_pads_with_zero_after_the_silu(cuda, dtype):
    """A constant image with beta != 0 normalises to beta everywhere. With ones
    for weights, an interior pixel sums 9 C silu(beta) and a corner 4 C: a halo
    of silu(beta) instead of zero would give 9 C at the corner too."""
    c = 64
    x = torch.full((1, 8, 20, c), 0.5, device=cuda, dtype=dtype)
    beta = torch.full((c,), 1.5, device=cuda)
    wk = torch.full((3, 3, c, 32), 1.0 / 64, device=cuda, dtype=dtype)
    out = gn_silu_conv3x3(x, torch.ones(c, device=cuda), beta, wk, torch.zeros(32, device=cuda)).float()
    s = torch.nn.functional.silu(beta[0]).to(dtype).float().item()
    for (yy, xx), taps in (((3, 9), 9), ((0, 0), 4), ((7, 19), 4), ((0, 5), 6), ((4, 19), 6)):
        assert abs(out[0, yy, xx, 0].item() - taps * s) <= 2e-2 * taps * s, (yy, xx)


@pytest.mark.cuda
def test_gn_silu_conv3x3_f32_on_planes_given_or_made(cuda):
    """The f32 form reads the weight's split planes: handed in (as a module
    caches them) it launches no prepass; made by the wrapper from a bare HWIO
    weight it launches one; both give the same bits."""
    from instarevive_tpu_torch.ops.gn_conv import weight_planes

    x, gamma, beta, wk, bias = _vae_inputs(cuda, torch.float32, 2, 24, 40, 128, 128, seed=6)
    planes = weight_planes(wk)
    prepass = tf32_planes.launches
    given = gn_silu_conv3x3(x, gamma, beta, wk, bias, planes=planes)
    assert tf32_planes.launches == prepass
    made = gn_silu_conv3x3(x, gamma, beta, wk, bias)
    torch.cuda.synchronize()
    assert tf32_planes.launches == prepass + 1 and torch.equal(given, made)


@pytest.mark.cuda
def test_vae_conv_weight_planes_are_packed_once_per_module(cuda):
    """In f32 each ResnetBlock conv packs its weight planes on its first
    forward, one prepass launch of shape (Co, 9, C), and none after."""
    from instarevive_tpu_torch.models.vae import ResnetBlock

    block = ResnetBlock(64, 128).to(cuda).eval().requires_grad_(False)
    x = torch.randn(2, 64, 16, 16, device=cuda).contiguous(memory_format=torch.channels_last)
    tf32_planes.shapes = {}
    try:
        block(x)
        first = dict(tf32_planes.shapes)
        tf32_planes.shapes.clear()
        block(x)
        torch.cuda.synchronize()
        second = dict(tf32_planes.shapes)
    finally:
        tf32_planes.shapes = None
    assert first == {(128, 9, 64, True, False): 1, (128, 9, 128, True, False): 1} and second == {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_silu_conv3x3_gradients_match_autograd_through_plain(cuda, dtype):
    """x, gamma, beta, w and bias require grad: the kernels forward, then the
    plain composition's gradient, against autograd through the plain version
    (the same backward; cuDNN's backward may sum in another order)."""
    inputs = _vae_inputs(cuda, dtype, 2, 24, 40, 128, 256, seed=7)
    cot = torch.randn(2, 24, 40, 256, device=cuda, generator=torch.Generator(device=cuda).manual_seed(8))
    grads = []
    for fn in (gn_silu_conv3x3, gn_silu_conv3x3_plain):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        launches = gn_silu_conv3x3.launches
        (fn(*leaves).float() * cot).sum().backward()
        assert gn_silu_conv3x3.launches == launches + (fn is gn_silu_conv3x3)
        grads.append([t.grad.float() for t in leaves])
    bound = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= bound * want.abs().max().item()


@pytest.mark.cuda
def test_vae_kernels_refuse_what_they_cannot_run(cuda):
    x, gamma, beta, wk, bias = _vae_inputs(cuda, torch.bfloat16, 1, 8, 8, 64, 64)
    with pytest.raises(ValueError, match="multiples of 32"):
        gn_silu_conv3x3(x[..., :48].contiguous(), gamma[:48], beta[:48], wk[:, :, :48].contiguous(), bias)
    with pytest.raises(ValueError, match="contiguous as NHWC"):
        gn_silu_conv3x3(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), gamma, beta, wk, bias)
    with pytest.raises(ValueError, match="contiguous as NHWC"):
        group_norm_silu(x[:, :, ::2], gamma, beta)
    with pytest.raises(ValueError, match="contiguous"):
        gn_silu_conv3x3(x, gamma, beta, wk.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0), bias)
    with pytest.raises(ValueError, match="contiguous"):
        gn_silu_conv3x3(x, gamma, beta, wk.float(), bias)
    with pytest.raises(ValueError, match="planes"):  # the f32 form's weight planes are (Co, 3, 3, C)
        gn_silu_conv3x3(x.float(), gamma, beta, wk.float(), bias, planes=(wk.float(), wk.float()))
    with pytest.raises(RuntimeError, match="no backward"):
        group_norm_silu(x, gamma.requires_grad_(), beta)
    with pytest.raises(ValueError, match="16 bytes"):
        upsample2x_nearest(x[..., :4].contiguous())
    with pytest.raises(TypeError):
        group_norm_silu(x.half(), gamma, beta)


def _swin_inputs(cuda, dtype, b, h, w, heads, hd, shift, masked=True, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    c = heads * hd
    qkv = torch.randn(b, h, w, 3 * c, device=cuda, generator=gen)
    qkv[..., 2 * c:] = torch.rand(b, h, w, c, device=cuda, generator=gen) * 2 - 1
    bias = torch.randn(heads, 64, 64, device=cuda, generator=gen) * 0.5
    mask = torch.from_numpy(W.shift_attn_mask(h, w, 8, shift)).to(cuda) if shift and masked else None
    return qkv.to(dtype), bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,h,w,heads,hd,shift,masked",
    [
        (4, 64, 64, 6, 30, 4, True),    # process at 4 x 512 x 512, a shifted block
        (4, 64, 64, 6, 30, 0, False),
        (1, 128, 128, 6, 30, 4, True),  # the tiled call: SwinIR on the whole 1024 x 1024 image
        (2, 64, 48, 6, 30, 4, True),    # a server bucket, not square
        (1, 16, 24, 6, 10, 4, True),    # the tiny configuration's head dim
        (1, 24, 16, 4, 32, 3, True),    # the widest head, an odd shift: window rows start at any pixel
        (3, 8, 8, 5, 8, 0, False),      # one window an image
        (1, 16, 16, 2, 2, 5, False),    # wrapped windows without a mask
    ],
)
def test_swin_window_attention_matches_plain(cuda, dtype, b, h, w, heads, hd, shift, masked):
    qkv, bias, mask = _swin_inputs(cuda, dtype, b, h, w, heads, hd, shift, masked)
    before = swin_window_attention.launches
    out = swin_window_attention(qkv, bias, mask, heads, 8, hd**-0.5, shift)
    torch.cuda.synchronize()
    assert swin_window_attention.launches == before + 1
    ref = swin_window_attention_plain(qkv, bias, mask, heads, 8, hd**-0.5, shift)
    assert out.dtype == dtype and out.shape == (b, h, w, heads * hd) and torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= SWIN_BOUNDS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,shift", [(3, 64, 104, 4), (3, 64, 104, 3)])
def test_swin_window_attention_walks_more_windows_than_blocks(cuda, dtype, b, h, w, shift):
    """312 windows (936 f32 items): more work items than the persistent grid
    has blocks, and not a multiple of them, so blocks walk different counts
    and every ring slot's barrier phase turns an odd number of times in some."""
    qkv, bias, mask = _swin_inputs(cuda, dtype, b, h, w, 6, 30, shift, seed=3)
    out = swin_window_attention(qkv, bias, mask, 6, 8, 30**-0.5, shift)
    ref = swin_window_attention_plain(qkv, bias, mask, 6, 8, 30**-0.5, shift)
    assert torch.isfinite(out).all() and (out.float() - ref.float()).abs().max().item() <= SWIN_BOUNDS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swin_window_attention_corner_windows_wrap_both_ways(cuda, dtype):
    """Shift 4 with SwinIR's own mask: the last window of each image takes its
    rows from two image rows and each row from two pixel runs; its output
    lands in the four corners of the map."""
    b, h, w = 2, 24, 40
    qkv, bias, mask = _swin_inputs(cuda, dtype, b, h, w, 6, 30, 4, seed=4)
    out = swin_window_attention(qkv, bias, mask, 6, 8, 30**-0.5, 4)
    ref = swin_window_attention_plain(qkv, bias, mask, 6, 8, 30**-0.5, 4)
    rows, cols = [*range(4), *range(h - 4, h)], [*range(4), *range(w - 4, w)]
    corner = (out.float() - ref.float())[:, rows][:, :, cols]
    assert torch.isfinite(out).all() and corner.abs().max().item() <= SWIN_BOUNDS[dtype]
    assert (out.float() - ref.float()).abs().max().item() <= SWIN_BOUNDS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,shift", [(4, 64, 64, 4), (1, 64, 64, 3), (3, 8, 8, 0)])
def test_swin_window_attention_repeats_its_bits(cuda, dtype, b, h, w, shift):
    qkv, bias, mask = _swin_inputs(cuda, dtype, b, h, w, 6, 30, shift, seed=5)
    first = swin_window_attention(qkv, bias, mask, 6, 8, 30**-0.5, shift)
    assert torch.equal(first, swin_window_attention(qkv, bias, mask, 6, 8, 30**-0.5, shift))


@pytest.mark.cuda
def test_swin_window_attention_f32_takes_an_odd_head_dim(cuda):
    qkv, bias, mask = _swin_inputs(cuda, torch.float32, 2, 16, 16, 3, 7, 4)
    out = swin_window_attention(qkv, bias, mask, 3, 8, 0.4, 4)
    ref = swin_window_attention_plain(qkv, bias, mask, 3, 8, 0.4, 4)
    assert (out - ref).abs().max().item() <= SWIN_BOUNDS[torch.float32]


@pytest.mark.cuda
def test_swin_window_attention_refuses_what_it_cannot_run(cuda):
    qkv, bias, mask = _swin_inputs(cuda, torch.bfloat16, 1, 16, 16, 6, 30, 4)
    with pytest.raises(ValueError, match="contiguous as NHWC"):
        swin_window_attention(qkv.permute(0, 2, 1, 3), bias, mask, 6, 8, 1.0, 4)
    with pytest.raises(TypeError, match="bf16 or f32"):
        swin_window_attention(qkv.half(), bias, mask, 6, 8, 1.0, 4)
    with pytest.raises(ValueError, match="window 8 only"):
        swin_window_attention(qkv, bias[:, :16, :16].contiguous(), None, 6, 4, 1.0, 0)
    with pytest.raises(ValueError, match="head dims up to 32"):
        swin_window_attention(qkv, bias[:3].contiguous(), None, 3, 8, 1.0, 0)  # head dim 60
    odd = torch.zeros(1, 8, 8, 3 * 6 * 5, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="even ones in bf16"):
        swin_window_attention(odd, bias, None, 6, 8, 1.0, 0)
    with pytest.raises(ValueError, match="bias must be"):
        swin_window_attention(qkv, bias.to(torch.bfloat16), mask, 6, 8, 1.0, 4)
    with pytest.raises(ValueError, match="bias must be"):
        swin_window_attention(qkv, bias.cpu(), mask, 6, 8, 1.0, 4)
    with pytest.raises(ValueError, match="mask must be"):
        swin_window_attention(qkv, bias, mask[:2].contiguous(), 6, 8, 1.0, 4)
    with pytest.raises(RuntimeError, match="takes no gradient"):  # qkv and the bias may take one, the mask may not
        swin_window_attention(qkv, bias, mask.clone().requires_grad_(), 6, 8, 1.0, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swinir_on_the_card_runs_the_kernels_and_agrees_with_the_cpu(cuda, dtype):
    """SwinIR at the v1 width, two blocks: one window-attention launch a block,
    one upsample launch a step, and the card's f32 output within 1e-4 of the
    CPU's (bf16: finite, within 0.1)."""
    from instarevive_tpu_torch.models.swinir import SwinIR
    from instarevive_tpu_torch.ops.norm_kernels import upsample2x_nearest

    torch.manual_seed(0)
    model = SwinIR(depths=(2,), num_heads=(6,)).eval().requires_grad_(False)
    for name, p in model.named_parameters():
        if name.endswith("relative_position_bias_table"):
            p.normal_(0.0, 0.5)
    x = torch.rand(2, 128, 192, 3)
    ref = model(x)
    card = SwinIR(depths=(2,), num_heads=(6,)).eval().requires_grad_(False)
    card.load_state_dict(model.state_dict())
    card.to(cuda)
    if dtype == torch.bfloat16:
        for name, p in card.named_parameters():
            if not name.endswith("relative_position_bias_table"):
                p.data = p.data.to(dtype)
    card.to(memory_format=torch.channels_last)
    attn, ups = swin_window_attention.launches, upsample2x_nearest.launches
    out = card(x.to(cuda))
    torch.cuda.synchronize()
    assert (swin_window_attention.launches - attn, upsample2x_nearest.launches - ups) == (2, 3)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out.float().cpu() - ref).abs().max().item() <= (1e-4 if dtype == torch.float32 else 0.1)


# ---------------------------------------------------------------------------
# filter2d (K6)

# The kernel against filter2d_plain, relative to the output's largest
# magnitude: both sum kh * kw products in f32, in another order.
FILTER_REL_BOUND = 1e-5


def _filter_inputs(cuda, shape, taps, per_sample, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    img = torch.rand(shape, device=cuda, generator=gen)
    kernel = torch.rand(((shape[0],) if per_sample else ()) + tuple(taps), device=cuda, generator=gen) - 0.2
    return img, kernel / kernel.abs().sum(dim=(-2, -1), keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,taps,per_sample",
    [
        ((2, 512, 512, 3), (21, 21), True),   # the stage-1 blur of degrade_batch at batch 2, crop 512
        ((2, 768, 768, 3), (21, 21), True),   # the stage-2 blur on the stage-1 canvas
        ((2, 160, 160, 3), (21, 21), True),   # the final sinc on the stage-2 canvas
        ((2, 512, 512, 3), (41, 41), True),   # the CodeFormer blur
        ((2, 512, 512, 3), (21, 21), False),  # a shared kernel
        ((1, 72, 200, 3), (7, 7), True),      # ragged: no multiple of the 32 x 64 tile
        ((3, 100, 36, 1), (21, 21), True),    # one channel, narrower than a tile
        ((2, 33, 65, 3), (41, 41), True),     # the padding nearly as large as the image
        ((2, 90, 130, 3), (5, 13), True),     # rectangular taps
        ((1, 21, 21, 2), (41, 41), False),    # reflect at its limit: pad 20 of 21
        ((1, 64, 96, 64), (41, 41), True),    # 16 bands of 4 channels, one launch
        ((1, 40, 40, 5), (1, 1), True),       # a single tap
        ((1, 48, 70, 128), (41, 41), True),   # 32 bands of 4 channels
        ((2, 37, 53, 1), (21, 21), True),     # one channel, H and W no multiple of any tile
        ((2, 45, 29, 2), (13, 13), True),     # two channels, ragged
        ((2, 19, 27, 5), (7, 7), True),       # five channels: bands of one
        ((1, 41, 50, 3), (41, 41), False),    # shared taps at 41, reflect at its limit in H
        ((1, 130, 90, 6), (21, 21), False),   # bands of two channels, shared taps
    ],
)
def test_filter2d_matches_plain(cuda, shape, taps, per_sample):
    """One launch at every C; within the bound of the plain version; the
    same inputs twice give the same bits."""
    img, kernel = _filter_inputs(cuda, shape, taps, per_sample)
    before = filter2d.launches
    out = filter2d(img, kernel)
    torch.cuda.synchronize()
    assert filter2d.launches - before == 1
    ref = filter2d_plain(img, kernel)
    assert out.shape == img.shape and out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= FILTER_REL_BOUND * ref.abs().max().item()
    assert torch.equal(filter2d(img, kernel), out)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 2, 1])
@pytest.mark.parametrize("c,taps,w,e", [(1, (21, 21), 384, 1), (2, (13, 13), 200, 2), (3, (21, 21), 130, 3),
                                        (5, (9, 9), 90, 1), (6, (7, 7), 70, 2), (64, (41, 41), 50, 4)])
def test_filter2d_every_instantiation_matches_plain(cuda, c, taps, w, e, rows):
    """Every band width and rows a thread the launcher can pick, each at the
    first image height where its plan (``filter2d_plan``, from the shape and
    the card's SM count) takes those rows: one launch, within the bound of
    the plain version."""
    from instarevive_tpu_torch.ops.filters import filter2d_plan

    h = next((h for h in range(taps[0] // 2 + 1, 2048) if filter2d_plan((2, h, w, c), taps)["rows"] == rows), None)
    assert h is not None, f"no height up to 2048 takes {rows} rows a thread at (2, h, {w}, {c})"
    plan = filter2d_plan((2, h, w, c), taps)
    assert plan["e"] == e and plan["tiles"] >= 1 and plan["blocks_per_sm"] >= 1, plan
    img, kernel = _filter_inputs(cuda, (2, h, w, c), taps, True)
    before = filter2d.launches
    out = filter2d(img, kernel)
    torch.cuda.synchronize()
    assert filter2d.launches - before == 1
    ref = filter2d_plain(img, kernel)
    assert (out - ref).abs().max().item() <= FILTER_REL_BOUND * ref.abs().max().item()


@pytest.mark.cuda
def test_filter2d_after_a_plan_of_fewer_taps(cuda):
    """A plan query for fewer taps, then a launch of the same instantiation
    that takes more shared memory (both under the 48 KB default): the query
    leaves the launch's limit alone."""
    from instarevive_tpu_torch.ops.filters import filter2d_plan

    shape = (2, 90, 130, 3)
    small, large = filter2d_plan(shape, (5, 5)), filter2d_plan(shape, (5, 13))
    assert (small["e"], small["rows"]) == (large["e"], large["rows"]) and small["smem"] < large["smem"] < 48 * 1024
    filter2d_plan(shape, (5, 5))
    img, kernel = _filter_inputs(cuda, shape, (5, 13), True)
    ref = filter2d_plain(img, kernel)
    assert (filter2d(img, kernel) - ref).abs().max().item() <= FILTER_REL_BOUND * ref.abs().max().item()


@pytest.mark.cuda
def test_filter2d_misaligned_image_takes_bands_of_one(cuda):
    """An image 4 bytes off a 16-byte boundary: the launcher drops to bands of
    one channel (its 4E-byte copies need 4E-byte alignment) and still matches."""
    from instarevive_tpu_torch.ops.filters import filter2d_plan

    shape, taps = (1, 40, 30, 64), (7, 7)
    img, kernel = _filter_inputs(cuda, shape, taps, True)
    flat = torch.empty(img.numel() + 1, device=cuda)
    shifted = flat[1:].view(shape)
    shifted.copy_(img)
    assert shifted.data_ptr() % 16 == 4 and filter2d_plan(shape, taps, align=4)["e"] == 1
    out = filter2d(shifted, kernel)
    ref = filter2d_plain(img, kernel)
    assert (out - ref).abs().max().item() <= FILTER_REL_BOUND * ref.abs().max().item()


@pytest.mark.cuda
def test_filter2d_reflects_and_repeats_its_bits(cuda):
    """One-neighbour taps on a ramp: reflect reads pixel 1 at the left border
    and row 1 at the top (an edge repeat would read pixel 0, row 0). The same
    inputs twice: the same bits."""
    ramp = torch.arange(40, dtype=torch.float32, device=cuda)
    img = (ramp[None, :, None, None] * 100 + ramp[None, None, :, None]).expand(2, 40, 40, 3).contiguous()
    kernel = torch.zeros(3, 3, device=cuda)
    kernel[1, 0] = 1.0
    out = filter2d(img, kernel)
    assert out[0, 5, 0, 0].item() == img[0, 5, 1, 0].item() and out[0, 5, 39, 0].item() == img[0, 5, 38, 0].item()
    kernel = torch.zeros(3, 3, device=cuda)
    kernel[0, 1] = 1.0  # reads the row above: reflect reads row 1 at the top
    out = filter2d(img, kernel)
    assert out[0, 0, 5, 0].item() == img[0, 1, 5, 0].item() and out[0, 39, 5, 0].item() == img[0, 38, 5, 0].item()
    img, kernel = _filter_inputs(cuda, (2, 200, 168, 3), (21, 21), True, seed=3)
    assert torch.equal(filter2d(img, kernel), filter2d(img, kernel))


@pytest.mark.cuda
def test_filter2d_refuses_what_it_cannot_run(cuda):
    img, kernel = _filter_inputs(cuda, (2, 64, 64, 3), (21, 21), True)
    with pytest.raises(ValueError, match="contiguous f32"):
        filter2d(img.bfloat16(), kernel)
    with pytest.raises(ValueError, match="contiguous f32"):
        filter2d(img.permute(0, 2, 1, 3), kernel)
    with pytest.raises(ValueError, match="contiguous f32"):
        filter2d(img, kernel.double())
    with pytest.raises(ValueError, match="contiguous f32"):
        filter2d(img, kernel.cpu())
    with pytest.raises(RuntimeError, match="no backward"):
        filter2d(img.clone().requires_grad_(), kernel)
    with pytest.raises(ValueError, match="odd sizes"):
        filter2d(img, kernel[:, :20, :20].contiguous())
    with pytest.raises(ValueError, match="odd sizes"):
        filter2d(img, torch.ones(43, 43, device=cuda))
    with pytest.raises(ValueError, match="reflect padding"):
        filter2d(img[:, :10].contiguous(), kernel)
    with pytest.raises(ValueError, match="kernel must be"):
        filter2d(img, kernel[:1].contiguous())
    dilated = filter2d(img, kernel[:, :5, :5].contiguous(), dilation=2)  # not the kernel's: the grouped convolution
    assert torch.equal(dilated, filter2d_plain(img, kernel[:, :5, :5].contiguous(), dilation=2))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["realesrgan", "codeformer"])
def test_degradation_on_the_card_agrees_with_the_cpu(cuda, which):
    """One set of host-side draws and CPU noise fields through the program on
    the card and on the CPU: within one 8-bit level on 99% of pixels, mean
    absolute difference under 2e-3 (the bound of the CPU parity test)."""
    from instarevive_tpu_torch.data import codeformer, realesrgan
    from instarevive_tpu_torch.tools.time_degrade import draws_on, forced_gaussian

    hq = torch.round(torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(0)) * 255) / 255
    gen = torch.Generator().manual_seed(1)
    if which == "realesrgan":
        cfg = realesrgan.RealESRGANDegradationConfig()
        draws = forced_gaussian(realesrgan.draw_degradation(torch.Generator().manual_seed(2), cfg, 2),
                                ((2, 384, 384, 3), (2, 80, 80, 3)), gen)  # the two canvases of a 256 crop
        run = lambda x, d: realesrgan.degrade_batch(None, x, cfg, draws=d)  # noqa: E731
    else:
        cfg = codeformer.CodeformerDegradationConfig()
        draws = codeformer.draw_codeformer(torch.Generator().manual_seed(2), cfg, 2)
        draws.fields = (torch.randn(2, 64, 64, 3, generator=gen), torch.randn(2, 64, 64, 1, generator=gen))
        run = lambda x, d: codeformer.degrade_batch_codeformer(None, x, cfg, draws=d)  # noqa: E731
    want = run(hq, draws)
    on_card = draws_on(draws, cuda)
    before = filter2d.launches
    got = run(hq.to(cuda), on_card)
    torch.cuda.synchronize()
    assert filter2d.launches - before == (2 + int(draws.blur2) if which == "realesrgan" else 1)
    diff = (got["lq"].cpu() - want["lq"]).abs()
    assert torch.equal(got["hq"].cpu(), want["hq"])
    assert (diff <= 1 / 255 + 1e-6).float().mean().item() >= 0.99 and diff.mean().item() < 2e-3


# ---------------------------------------------------------------------------
# the autograd.Functions of K4 and K5c: kernel forward, plain backward


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,shift", [(2, 64, 64, 4), (2, 64, 64, 0), (1, 16, 24, 4)])
def test_swin_window_attention_with_grad_is_kernel_forward_plain_backward(cuda, dtype, b, h, w, shift):
    heads, hd = 6, 30
    qkv, bias, mask = _swin_inputs(cuda, dtype, b, h, w, heads, hd, shift)
    qkv.requires_grad_(True)
    bias.requires_grad_(True)
    grad = torch.randn(b, h, w, heads * hd, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1)).to(dtype)
    before = swin_window_attention.launches
    out = swin_window_attention(qkv, bias, mask, heads, 8, hd**-0.5, shift)
    got = torch.autograd.grad(out, (qkv, bias), grad)
    torch.cuda.synchronize()
    assert swin_window_attention.launches == before + 1  # the forward launches the kernel, the backward nothing
    ref = swin_window_attention_plain(qkv, bias, mask, heads, 8, hd**-0.5, shift)
    want = torch.autograd.grad(ref, (qkv, bias), grad)
    assert (out.float() - ref.float()).abs().max().item() <= SWIN_BOUNDS[dtype]
    # the backward is autograd through the plain version on the same saved inputs: the same arithmetic
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and (g.float() - w_.float()).abs().max().item() <= 1e-6 * max(1.0, w_.abs().max().item())
    with torch.no_grad():  # outside autograd a tensor that requires grad launches the kernel as before
        assert torch.equal(swin_window_attention(qkv, bias, mask, heads, 8, hd**-0.5, shift), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_upsample2x_with_grad_is_kernel_forward_and_the_two_by_two_sum(cuda, dtype):
    x = torch.randn(2, 24, 40, 64, device=cuda).to(dtype).requires_grad_(True)
    grad = torch.randn(2, 48, 80, 64, device=cuda).to(dtype)
    before = upsample2x_nearest.launches
    out = upsample2x_nearest(x)
    (got,) = torch.autograd.grad(out, x, grad)
    assert upsample2x_nearest.launches == before + 1 and torch.equal(out, upsample2x_nearest_plain(x))
    (want,) = torch.autograd.grad(upsample2x_nearest_plain(x.float()), x, grad.float())
    assert got.dtype == dtype and (got.float() - want.float()).abs().max().item() <= (4e-2 if dtype == torch.bfloat16 else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_swinir_train_step_on_the_card_agrees_with_the_cpu(cuda, bf16):
    """One SwinIR training step (``SwinIRTask.train_step``) at the v1 width,
    two blocks, on the card and on the CPU from the same weights and pair:
    f32 within 1e-3 (loss relative; each gradient against the largest gradient
    magnitude); bf16 compute from f32 masters: finite f32 gradients, the bias
    tables' included, K4 once a block and K5c three times in the forward only."""
    from instarevive_tpu_torch.config import load_config, merge
    from instarevive_tpu_torch.train import launcher
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = merge(load_config(os.path.join(repo, "configs", "instarevive_v1.yaml")),
                {"swinir": {"depths": [2], "num_heads": [6]}})
    argv = ["--task", "swinir", "--data", "-", "--out", "-", "--batch_size", "2", "--crop_size", "128"]
    args = launcher.parse_args(argv + (["--bf16"] if bf16 else []))
    cpu = launcher.SwinIRTask(launcher.parse_args(argv + ["--device", "cpu"]), cfg, torch.device("cpu"))
    card = launcher.SwinIRTask(args, cfg, cuda)
    card.model.load_state_dict(cpu.model.state_dict())
    gen = torch.Generator().manual_seed(0)
    hq = torch.rand(2, 128, 128, 3, generator=gen)
    data = {"hq": hq * 2 - 1, "lq": (hq + 0.1 * torch.randn(hq.shape, generator=gen)).clamp(0, 1)}
    want, got = [], []
    m_cpu = cpu.train_step(data, keep_grads=want)
    attn, ups = swin_window_attention.launches, upsample2x_nearest.launches
    m_card = card.train_step({k: v.to(cuda) for k, v in data.items()}, keep_grads=got)
    torch.cuda.synchronize()
    assert (swin_window_attention.launches - attn, upsample2x_nearest.launches - ups) == (2, 3)
    assert float(m_card["grads_finite"]) == 1.0 and all(g.dtype == torch.float32 for g in got)
    names = card.states[0].names
    tables = [g for n, g in zip(names, got) if n.endswith("relative_position_bias_table")]
    assert len(tables) == 2 and all(float(g.abs().max()) > 0 for g in tables)
    top = max(g.abs().max().item() for g in want)
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(got, want)) / top
    rel_loss = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / float(m_cpu["loss"])
    assert (rel_loss <= 1e-3 and err <= 1e-3) if not bf16 else (rel_loss <= 0.05 and err <= 0.2)


@pytest.mark.cuda
def test_nan_guard_reads_no_flag_on_the_host(cuda):
    """Under ``set_sync_debug_mode("error")`` a guarded step, finite or not,
    never waits for the card; a NaN gradient leaves the state's bits."""
    from instarevive_tpu_torch.train import optim
    from instarevive_tpu_torch.train.state import TrainState
    from instarevive_tpu_torch.utils.debug import nan_guard

    module = torch.nn.Linear(64, 32).to(cuda)
    state = TrainState.create(module, optim.build_optimizer("adamw", optim.constant_with_warmup(1e-2, 2)), ema=True)
    good = [torch.randn_like(p) for p in state.params]
    bad = [g.clone() for g in good]
    bad[0][3, 5] = float("nan")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = {}
        nan_guard(state, good, metrics)
        before = [t.clone() for t in (*state.params, *state.ema_params, *state.opt_state["inner"]["mu"],
                                      *state.opt_state["inner"]["nu"])]
        nan_guard(state, bad, metrics)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = [*state.params, *state.ema_params, *state.opt_state["inner"]["mu"], *state.opt_state["inner"]["nu"]]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(state.step) == 1 and int(state.opt_state["inner"]["count"]) == 1 and float(metrics["grads_finite"]) == 0.0


@pytest.mark.cuda
def test_cldm_step_on_the_card_agrees_with_the_cpu(cuda):
    """One f32 ``CLDMTask.train_step`` at head dim 64 (so the d = 64 kernels
    run, forward and backward), depth cut, every layer random (no zero
    init): the card against the CPU on the same weights, pair and draws;
    loss and every gradient within 1e-3 of their largest magnitude."""
    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.train import launcher
    from instarevive_tpu_torch.pipelines.build import init_params

    net = dict(model_channels=64, num_res_blocks=1, attention_ds=[1, 2], channel_mult=[1, 2], num_head_channels=64,
               context_dim=64)
    cfg = {"unet": dict(net, in_channels=4, out_channels=4), "controlnet": dict(net, in_channels=8, is_controlnet=True),
           "vae": {"ch": 64, "ch_mult": [1, 2, 8], "num_res_blocks": 1},  # a 512-wide mid block: K1's head dim 512
           "swinir": {"embed_dim": 60, "depths": [2], "num_heads": [6], "window": 8, "sf": 8, "unshuffle": True,
                      "unshuffle_scale": 8},
           "schedule": {"name": "ldm_linear", "num_timesteps": 1000}}
    args = launcher.parse_args(["--task", "cldm", "--data", "-", "--out", "-", "--batch_size", "2"])
    cpu, gpu = launcher.CLDMTask(args, cfg, torch.device("cpu")), launcher.CLDMTask(args, cfg, cuda)
    init_params(cpu.model, seed=3)  # every layer random, so every gradient is exercised
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.pipe.load_state_dict(cpu.pipe.state_dict())  # the frozen SwinIR and VAE too: their inits drew on two devices
    gen = torch.Generator().manual_seed(0)
    pair = {"hq": torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1, "lq": torch.rand(2, 64, 64, 3, generator=gen)}
    draws = {"t": torch.tensor([17, 803]), "noise": torch.randn(2, 16, 16, 4, generator=gen)}  # the VAE's factor is 4
    out = {}
    for label, task in (("cpu", cpu), ("cuda", gpu)):
        kept = []
        before = (A.flash_attention.launches, A.flash_dq.launches, A.flash_dkv.launches)
        metrics = task.train_step({k: v.to(task.device) for k, v in pair.items()}, keep_grads=kept,
                                  draws={k: v.to(task.device) for k, v in draws.items()})
        counts = [a - b for a, b in zip((A.flash_attention.launches, A.flash_dq.launches, A.flash_dkv.launches), before)]
        out[label] = (float(metrics["loss"]), [g.cpu() for g in kept], counts)
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, counts) = out["cpu"], out["cuda"]
    # two attentions a transformer: the UNet's 2 + 1 + 4 and the ControlNet's 3 forward, and the mid block of each
    # of the two VAE encodes; the backward for the ControlNet's and the UNet decoder's
    assert counts == [2 * 10 + 2, 2 * 7, 2 * 7]
    assert abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu)
    top = max(g.abs().max().item() for g in g_cpu)
    assert max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu)) <= 1e-3 * top
