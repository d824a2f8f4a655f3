#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``instarevive_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. It imports no JAX. In order it:

1. prints the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions;
2. builds the kernel libraries (``csrc/flash_attn_fwd.cu``,
   ``csrc/flash_attn_bwd.cu``, ``csrc/norm_kernels.cu``, ``csrc/gn_conv.cu``,
   ``csrc/swin_attention.cu``, ``csrc/filter2d.cu``), one nvcc each, all
   started together, and prints each build time with the registers and spills;
   for the bf16 head-dim-64/72 forward also its shared memory a block, blocks
   an SM and its count of wgmma (HGMMA) and TMA-load (UTMALDG) instructions,
   and fails if either count is 0;
3. holds every kernel against its plain PyTorch version at the shapes the
   main path gives it, with a stated bound, and times the kernel, the plain
   version and, as a yardstick only, the one library call or composition for
   the same function: flash attention (K1, with ragged and masked shapes
   and its TFLOP/s), the fused GN+SiLU+conv3x3 (K3,
   with a border case that tells a zero halo from a ``silu(b)`` halo), the
   GroupNorm moments and fold (K5a), the GroupNorm apply (K5b), the
   nearest 2x upsample (K5c), the Swin window attention (K4, shifted and
   unshifted, bf16 and f32) and the per-sample reflect-padded 2-D filter (K6,
   f32, at the shapes of both degradation programs, ragged shapes, a shared
   kernel, and a border case that tells reflect from edge repeat);
4. runs a small full-width pipeline (depth cut) in f32 on the card and on
   the CPU, and holds the two against each other;
5. builds the full-width ``configs/instarevive_v1.yaml`` pipeline in bf16
   with seeded random weights, runs ``process`` on a 4x512x512 batch and
   ``process_tiled`` on a 1024x1024 image, checks the outputs and that every
   kernel was launched exactly as often as the configuration says, and
   prints seconds, MP/s and peak memory;
6. runs the CLI (``python -m instarevive_tpu_torch.inference``) on two PNGs;
7. starts the port's server (``instarevive_tpu_torch.serve``) in this process
   at full width in bf16, sends it concurrent ``POST /restore`` requests in
   two shape buckets, checks every answer and ``/healthz``, runs the demo's
   restorer (``instarevive_tpu_torch.interface``) on one image, and holds one
   answer of a depth-cut f32 server against ``process`` called directly;
8. runs the trainer (``instarevive_tpu_torch.train``) at full width in bf16
   from f32 master weights on 8 PNGs it writes from a seed: 3 steps of DMD
   distillation, then 1 more from the checkpoint, with the launches of K1 and
   K2 per step held to what the configuration implies; times warm steps;
   runs ``--lowmem`` at depth 2; and holds one depth-2 f32 train step on the
   card against the CPU;
9. runs both degradation programs (``data/realesrgan.degrade_batch``,
   ``data/codeformer.degrade_batch_codeformer``) on a seeded (2, 512, 512, 3)
   batch on the card: outputs checked, K6's launches held to what the draws
   imply and its shapes to those held in 3, the same seed twice, the card
   against the CPU under one set of handed-in draws, wall and split per call;
10. runs the trainer with ``--task swinir`` at the full v1 SwinIR width in
   bf16 from f32 masters, batch 2 at 512x512: 3 steps, then 1 more from the
   checkpoint, K4, K5c and K6 launches per step held; times warm steps; and
   holds one depth-cut f32 step on the card against the CPU;
11. holds the flash-attention kernels at head dim 64 (K1 with and without the
   log-sum-exp, K2's dq and dk/dv) against their plain versions at every
   UNet and ControlNet shape of ``configs/cldm.yaml``, bf16 and f32, timed
   against ``F.scaled_dot_product_attention`` forward and backward (this
   runs with the other kernel phases, after 3);
12. runs the trainer with ``--task cldm`` at the full ``configs/cldm.yaml``
   width (SD-2.1 UNet, ControlNet, the frozen SwinIR and VAE) in bf16 from f32
   masters, batch 2 at 512x512: 3 steps, then 1 more from the checkpoint,
   every kernel's launches per step held (K1 by head dim), every head-dim-64
   shape held in 11, frozen weights unchanged, one ``train_step`` under
   ``torch.cuda.set_sync_debug_mode("error")``; times warm steps; takes one
   ``--task reflow`` step; and holds one depth-cut f32 step at head dim 64 on
   the card against the CPU.

It then prints one JSON line describing the kernels, the card line again
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before that last line; without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Bounds for the kernel against sdpa on the same inputs (V in [-1, 1], so
# |out| <= 1). bf16: both outputs are rounded to bf16 (spacing 2^-8 just
# below 1) and the kernel rounds P to bf16 before P.V where sdpa keeps it
# f32, so a few bf16 steps; 1e-2. f32: only the summation order differs
# (online softmax over key tiles against one softmax); 1e-4.
BOUNDS = {"bf16": 1e-2, "f32": 1e-4}
# The backward kernels against flash_backward_plain on the same q, k, v, o, lse
# and dO (randn q, k, dO; v in [-1, 1]), per output (dq, dk, dv), relative to
# that output's largest magnitude. bf16: both round P, dS and the output to
# bf16 at the same places; an f32 sum taken in another order can land on the
# other side of a rounding boundary, which moves an output by one bf16 step
# (2^-8 = 3.9e-3 of the largest value) and a P or dS term by as much of
# itself; 1e-2. f32: only the order of the sums and expf differ; 2e-5.
# The log-sum-exp (about log Nk + 0.5, under 8 here) is f32 in both forms:
# the bf16 form works in the log2 domain (exp2f, log2f); 1e-3 and 1e-4.
BACKWARD_BOUNDS = {"bf16": 1e-2, "f32": 2e-5}
LSE_BOUNDS = {"bf16": 1e-3, "f32": 1e-4}
# The VAE kernels against their plain versions. Inputs are N(offset, scale^2)
# per channel, so |normalised x| stays under about 8 and, with weights of
# variance 1/(9C), |out| of the convolution under about 4.
# f32: the kernel and the plain version sum in other orders; 2e-4.
# bf16 norm: both round one f32 value of size < 8 to bf16 (spacing 2^-5
# there), and the two f32 values differ by summation order, which can move a
# value across a rounding boundary: one bf16 step, 3.2e-2.
# bf16 conv: the same for the output (|out| < 4: one step is 1.6e-2), plus
# the few activations among 9C that the two versions round to neighbouring
# bf16 values before the products; 4e-2.
# The fold (a, b) is f32 whatever x is, and its size follows the data's
# scale: it is held to 1e-5 relative to max(|a|, |b|) (max_rel_err), and the
# absolute error max(|da|, |db|) is reported beside it (max_abs_err).
NORM_BOUNDS = {"bf16": 3.2e-2, "f32": 2e-4}
CONV_BOUNDS = {"bf16": 4e-2, "f32": 2e-4}
FOLD_REL_BOUND = 1e-5
# Window attention against its plain version, v in [-1, 1] so |out| <= 1.
# The bf16 kernel keeps 16 bits of P (two bf16 terms) and exact q, k, v, so
# before the output is rounded it differs from the plain version's f32 value
# by summation order only. Both then round to bf16: at most one bf16 step
# below 1 apart, 2^-8 (4e-3); against the unrounded f32 reference the kernel
# is within half a step, 2^-9, plus that order (2.1e-3). f32: order only, 1e-5.
SWIN_BOUNDS = {"bf16": 4e-3, "f32": 1e-5}
SWIN_F32_REF_BOUND = 2.1e-3
# The card's published peaks (H100 SXM): device memory bytes/s, dense
# tensor-core bf16 FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
# The small f32 pipeline, card against CPU: convolutions and matmuls sum in
# other orders (TF32 is off), outputs are in [0, 1].
PIPELINE_F32_BOUND = 1e-3
# One f32 train step at depth 2, card against CPU: each loss relative to
# itself, each model's gradient relative to its largest magnitude; matmuls,
# LayerNorm and the attention kernels sum in other orders than the CPU.
TRAIN_F32_BOUND = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dt: str):
    """(least ms the card could take, which limit sets it): bytes moved once
    over the memory rate, or operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / (PEAK_BF16 if dt == "bf16" else PEAK_F32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


DTYPES = {"bf16": "bfloat16", "f32": "float32"}


def vae_inputs(gen, dt, n, h, w, c, co=None):
    """Activations with a per-channel offset and scale, so that mean and
    variance matter; norm parameters near (1, 0); weights ~ N(0, 1/(9C))."""
    import torch

    dtype = getattr(torch, DTYPES[dt])
    offset = torch.randn(c, device="cuda", generator=gen)
    scale = torch.rand(c, device="cuda", generator=gen) + 0.5
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    x = x.mul_(scale).add_(offset).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
    if co is None:
        return x, gamma, beta
    wk = (torch.randn(3, 3, c, co, device="cuda", generator=gen) * (9 * c) ** -0.5).to(dtype)
    bias = 0.1 * torch.randn(co, device="cuda", generator=gen)
    return x, gamma, beta, wk, bias


def max_err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def conv_phase():
    """K3 against the plain version at every shape of the main path; the
    yardstick is group_norm -> silu -> conv2d in channels-last. ``ms`` is the
    wrapper's time, the moments and fold launches inside it included;
    ``conv_only_ms`` is the convolution kernel alone on a fold made before.
    Returns per-shape records."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import gn_conv
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain
    from instarevive_tpu_torch.ops.norm_kernels import gn_affine

    b4 = [  # process at 4 x 512 x 512: (H = W, C, Co)
        (512, 128, 128), (256, 128, 256), (256, 256, 256), (128, 256, 512),
        (128, 512, 512), (64, 512, 512), (256, 512, 256), (512, 256, 128),
    ]
    cases = [(f"b4_{hw}_{c}_{co}", (4, hw, hw, c, co), ("bf16",)) for hw, c, co in b4]
    encode = [(1024, 128, 128), (512, 128, 256), (512, 256, 256), (256, 256, 512), (256, 512, 512), (128, 512, 512)]
    cases += [(f"tiled_encode_{hw}_{c}_{co}", (1, hw, hw, c, co), ("bf16",)) for hw, c, co in encode]
    tile = [(72, 512, 512), (144, 512, 512), (288, 512, 256), (288, 256, 256), (576, 256, 128), (576, 128, 128)]
    cases += [(f"tile576_{hw}_{c}_{co}", (1, hw, hw, c, co), ("bf16",)) for hw, c, co in tile]
    cases += [("b4_64_512_512", (4, 64, 64, 512, 512), ("f32",)),
              ("tile576_72_512_512", (1, 72, 72, 512, 512), ("f32",)),
              ("small_128_128_128", (2, 128, 128, 128, 128), ("f32",))]
    records = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, (n, h, w, c, co), dts in cases:
        for dt in dts:
            x, gamma, beta, wk, bias = vae_inputs(gen, dt, n, h, w, c, co)
            x_cl = x.permute(0, 3, 1, 2)  # the same memory as a channels-last NCHW tensor
            w_oihw = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            gl, bl, biasl = gamma.to(x.dtype), beta.to(x.dtype), bias.to(x.dtype)

            def library():
                return F.conv2d(F.silu(F.group_norm(x_cl, 32, gl, bl, 1e-6)), w_oihw, biasl, padding=1)

            with torch.no_grad():
                out = gn_silu_conv3x3(x, gamma, beta, wk, bias)
                torch.cuda.synchronize()
                ref = gn_silu_conv3x3_plain(x, gamma, beta, wk, bias)
                err = max_err(out, ref)
                if not torch.isfinite(out).all():
                    fail(f"gn_conv {name} {dt}: kernel output is not finite")
                del ref
                iters = 5 if n * h * w >= 2**20 else 10
                ms = cuda_ms(lambda: gn_silu_conv3x3(x, gamma, beta, wk, bias), iters=iters)
                a, b = gn_affine(x, gamma, beta)
                conv_ms = cuda_ms(lambda: gn_conv._launch(x, a, b, wk, bias), iters=iters)
                plain_ms = cuda_ms(lambda: gn_silu_conv3x3_plain(x, gamma, beta, wk, bias), iters=3, warmup=1)
                lib_ms = cuda_ms(library, iters=iters)
            flops = 2.0 * n * h * w * 9 * c * co
            nbytes = x.element_size() * (x.numel() + wk.numel() + out.numel())
            b_ms, b_by = bound(nbytes, flops, dt)
            rec = dict(name=name, dtype=dt, shape=[n, h, w, c, co], max_abs_err=err, bound=CONV_BOUNDS[dt], ms=ms,
                       includes="gn_stats_fold", conv_only_ms=conv_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, tflops=flops / ms / 1e9)
            print(f"[gn_conv] {name:27s} {dt:4s} N,H,W,C,Co={n},{h},{w},{c},{co} max_abs_err={err:.3e} "
                  f"(bound {CONV_BOUNDS[dt]:.0e}) ms={ms:.4f} ({rec['tflops']:.1f} TFLOP/s; conv alone {conv_ms:.4f}) "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
            if not err <= CONV_BOUNDS[dt]:
                fail(f"gn_conv {name} {dt}: kernel differs from the plain version by {err} > {CONV_BOUNDS[dt]}")
            records.append(rec)
            del x, x_cl, wk, w_oihw, out

    # A constant image with beta != 0 normalises to beta everywhere. With equal
    # weights an interior pixel sums 9 taps of silu(beta), an edge 6, a corner
    # 4; a halo of silu(b) instead of zero would give 9 everywhere.
    c = 64
    x = torch.full((1, 8, 20, c), 0.5, device="cuda", dtype=torch.bfloat16)
    beta = torch.full((c,), 1.5, device="cuda")
    wk = torch.full((3, 3, c, 32), 1.0 / c, device="cuda", dtype=torch.bfloat16)
    out = gn_silu_conv3x3(x, torch.ones(c, device="cuda"), beta, wk, torch.zeros(32, device="cuda")).float()
    s = F.silu(beta[0]).to(torch.bfloat16).float().item()
    for (yy, xx), taps in (((3, 9), 9), ((0, 0), 4), ((7, 19), 4), ((0, 5), 6), ((4, 19), 6), ((4, 0), 6)):
        got = out[0, yy, xx, 0].item()
        if abs(got - taps * s) > 2e-2 * taps * s:
            fail(f"gn_conv border: pixel ({yy}, {xx}) is {got}, expected {taps} taps of {s}: the halo is not zero")
    print(f"[gn_conv] border case: corner 4, edge 6, interior 9 taps of silu(beta)={s:.4f}: the halo is zero", flush=True)
    return records


def norm_phase():
    """K5a (moments + fold), K5b (apply) and K5c (upsample) against their plain
    versions. Yardsticks: torch.var_mean for the moments, F.group_norm
    (+ F.silu) for moments + apply, F.interpolate for the upsample. Returns
    (stats records, apply records, upsample records)."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops.norm_kernels import (
        affine_silu, affine_silu_plain, gn_affine, gn_affine_plain, group_norm_silu, group_norm_silu_plain,
        upsample2x_nearest, upsample2x_nearest_plain,
    )

    shapes = [  # (name, (N, H, W, C), dtypes)
        ("b4_64_512", (4, 64, 64, 512), ("bf16", "f32")),         # AttnBlock.norm, encoder norm_out
        ("b4_512_128", (4, 512, 512, 128), ("bf16",)),            # decoder norm_out; level-0 ResnetBlocks
        ("b4_256_256", (4, 256, 256, 256), ("bf16",)),
        ("b4_128_512", (4, 128, 128, 512), ("bf16",)),
        ("tiled_encode_1024_128", (1, 1024, 1024, 128), ("bf16",)),
        ("tiled_encode_128_512", (1, 128, 128, 512), ("bf16",)),
        ("tile576_72_512", (1, 72, 72, 512), ("bf16",)),
        ("tile576_576_128", (1, 576, 576, 128), ("bf16",)),
    ]
    stats, applies, ups = [], [], []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, (n, h, w, c), dts in shapes:
        for dt in dts:
            x, gamma, beta = vae_inputs(gen, dt, n, h, w, c)
            x_cl = x.permute(0, 3, 1, 2)
            esize = x.element_size()
            with torch.no_grad():
                a, b = gn_affine(x, gamma, beta)
                torch.cuda.synchronize()
                a_ref, b_ref = gn_affine_plain(x, gamma, beta)
                scale = max(a_ref.abs().max().item(), b_ref.abs().max().item())
                abs_err = max(max_err(a, a_ref), max_err(b, b_ref))
                err = abs_err / scale
                if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                    fail(f"gn_affine {name} {dt}: the fold is not finite")
                ms = cuda_ms(lambda: gn_affine(x, gamma, beta))
                plain_ms = cuda_ms(lambda: gn_affine_plain(x, gamma, beta), iters=3, warmup=1)
                xg = x.view(n, h * w, 32, c // 32)
                lib_ms = cuda_ms(lambda: torch.var_mean(xg, dim=(1, 3)))
            b_ms, b_by = bound(esize * x.numel() + 8 * n * c, 3.0 * x.numel(), "f32")
            rec = dict(name=name, dtype=dt, shape=[n, h, w, c], max_abs_err=abs_err, max_rel_err=err,
                       rel_bound=FOLD_REL_BOUND, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by,
                       gbytes_per_s=esize * x.numel() / ms / 1e6)
            print(f"[gn_stats] {name:22s} {dt:4s} N,H,W,C={n},{h},{w},{c} max_abs_err(a,b)={abs_err:.3e} "
                  f"rel_err={err:.3e} (bound {FOLD_REL_BOUND:.0e}) ms={ms:.4f} ({rec['gbytes_per_s']:.0f} GB/s) plain_ms={plain_ms:.4f} "
                  f"var_mean_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
            if not err <= FOLD_REL_BOUND:
                fail(f"gn_affine {name} {dt}: fold differs from the plain version by {err} (relative)")
            stats.append(rec)

            for silu in (True, False):
                gl, bl = gamma.to(x.dtype), beta.to(x.dtype)

                def library():
                    y = F.group_norm(x_cl, 32, gl, bl, 1e-6)
                    return F.silu(y) if silu else y

                with torch.no_grad():
                    out = group_norm_silu(x, gamma, beta, silu=silu)
                    torch.cuda.synchronize()
                    err = max_err(out, group_norm_silu_plain(x, gamma, beta, silu=silu))
                    if not torch.isfinite(out).all():
                        fail(f"group_norm_silu {name} {dt}: kernel output is not finite")
                    ms = cuda_ms(lambda: affine_silu(x, a, b, silu))
                    plain_ms = cuda_ms(lambda: affine_silu_plain(x, a, b, silu), iters=3, warmup=1)
                    both_ms = cuda_ms(lambda: group_norm_silu(x, gamma, beta, silu=silu))
                    lib_ms = cuda_ms(library)
                b_ms, b_by = bound(2 * esize * x.numel(), 6.0 * x.numel(), "f32")
                rec = dict(name=name, dtype=dt, shape=[n, h, w, c], silu=silu, max_abs_err=err,
                           bound=NORM_BOUNDS[dt], ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by, stats_and_apply_ms=both_ms, gbytes_per_s=2 * esize * x.numel() / ms / 1e6)
                print(f"[gn_apply] {name:22s} {dt:4s} silu={silu!s:5s} max_abs_err={err:.3e} "
                      f"(bound {NORM_BOUNDS[dt]:.1e}) ms={ms:.4f} ({rec['gbytes_per_s']:.0f} GB/s) plain_ms={plain_ms:.4f} "
                      f"stats+apply_ms={both_ms:.4f} group_norm_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
                if not err <= NORM_BOUNDS[dt]:
                    fail(f"group_norm_silu {name} {dt} silu={silu}: differs from the plain version by {err}")
                applies.append(rec)
                del out
            del x, x_cl, xg

    up_shapes = [("b4_64_512", (4, 64, 64, 512)), ("b4_128_512", (4, 128, 128, 512)), ("b4_256_256", (4, 256, 256, 256)),
                 ("tile576_72_512", (1, 72, 72, 512)), ("tile576_144_512", (1, 144, 144, 512)),
                 ("tile576_288_256", (1, 288, 288, 256)),
                 # SwinIR's upsampler, 64 features: process at 4 x 512 x 512, then the tiled call's whole image
                 ("swinir_b4_64_64", (4, 64, 64, 64)), ("swinir_b4_128_64", (4, 128, 128, 64)),
                 ("swinir_b4_256_64", (4, 256, 256, 64)), ("swinir_b1_128_64", (1, 128, 128, 64)),
                 ("swinir_b1_256_64", (1, 256, 256, 64)), ("swinir_b1_512_64", (1, 512, 512, 64))]
    for name, (n, h, w, c) in up_shapes:
        x = torch.randn(n, h, w, c, device="cuda", generator=gen).to(torch.bfloat16)
        x_cl = x.permute(0, 3, 1, 2)
        out = upsample2x_nearest(x)
        torch.cuda.synchronize()
        err = max_err(out, upsample2x_nearest_plain(x))
        ms = cuda_ms(lambda: upsample2x_nearest(x))
        plain_ms = cuda_ms(lambda: upsample2x_nearest_plain(x))
        lib_ms = cuda_ms(lambda: F.interpolate(x_cl, scale_factor=2, mode="nearest"))
        b_ms, b_by = bound(5 * 2 * x.numel(), 0.0, "bf16")
        rec = dict(name=name, dtype="bf16", shape=[n, h, w, c], max_abs_err=err, bound=0.0, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, gbytes_per_s=10 * x.numel() / ms / 1e6)
        print(f"[upsample] {name:22s} bf16 N,H,W,C={n},{h},{w},{c} max_abs_err={err:.1e} (exact) ms={ms:.4f} "
              f"({rec['gbytes_per_s']:.0f} GB/s) plain_ms={plain_ms:.4f} interpolate_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if err != 0.0:
            fail(f"upsample2x_nearest {name}: differs from the plain version by {err}")
        ups.append(rec)
        del x, x_cl, out
    return stats, applies, ups


def hopper_build_report(log: str):
    """The bf16 head-dim-64/72 forward as built: registers and spill stores of
    each instantiation (ptxas, when this run compiled it), the shared memory a
    block takes and the blocks an SM holds (the library's own figures), and
    its count of HGMMA (wgmma) and UTMALDG (TMA load) instructions in the
    library's SASS. Fails if either count is 0."""
    import ctypes
    import shutil

    from instarevive_tpu_torch.ops import cuda_build

    report = {}
    for fn_name, body in re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S):
        m = re.search(r"hopper6kernelILi(\d+)E", fn_name)
        if m:
            report[f"d{m.group(1)}_registers"] = int(re.search(r"Used (\d+) registers", body).group(1))
            report[f"d{m.group(1)}_spill_stores"] = int(re.search(r"(\d+) bytes spill stores", body).group(1))
    occupancy = cuda_build.load_library("flash_attn_fwd").flash_attn_fwd_occupancy
    occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    for d in (64, 72):
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        if occupancy(d, ctypes.byref(smem), ctypes.byref(blocks)) != 0:
            fail(f"flash_attn_fwd_occupancy({d}) failed")
        report[f"d{d}_smem_bytes"], report[f"d{d}_blocks_per_sm"] = smem.value, blocks.value
    so = cuda_build.library_path("flash_attn_fwd", cuda_build.LIBRARIES["flash_attn_fwd"])
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    report["HGMMA"], report["UTMALDG"] = sass.count("HGMMA"), sass.count("UTMALDG")
    print(f"[build] flash_attn_fwd.cu, the bf16 head-dim-64/72 form: {report}", flush=True)
    if not (report["HGMMA"] and report["UTMALDG"]):
        fail(f"the forward library has {report['HGMMA']} HGMMA and {report['UTMALDG']} UTMALDG instructions")
    return report


def kernel_phase():
    """K1 against sdpa at the main-path shapes; returns per-shape records."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops.attention import flash_attention, sdpa

    cases = [  # (name, (B, H, Nq, Nk, D), masked, dtypes)
        ("dit_self", (4, 16, 1024, 1024, 72), False, ("bf16", "f32")),
        ("dit_cross", (4, 16, 1024, 300, 72), False, ("bf16", "f32")),
        ("dit_cross_masked", (4, 16, 1024, 300, 72), True, ("bf16", "f32")),
        ("vae_mid", (4, 1, 4096, 4096, 512), False, ("bf16",)),
        ("dit_self_tile576", (4, 16, 1296, 1296, 72), False, ("bf16",)),
        ("ragged_q1000_k77_masked", (1, 16, 1000, 77, 72), True, ("bf16",)),
        ("ragged_q1000_k333", (1, 16, 1000, 333, 72), False, ("bf16",)),
    ]
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    records = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, h, nq, nk, d), masked, dts in cases:
        for dt in dts:
            q = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtypes[dt])
            k = torch.randn(b, h, nk, d, device="cuda", generator=gen).to(dtypes[dt])
            v = (torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1).to(dtypes[dt])
            mask = None
            if masked:  # ragged lengths, one row with no key at all (at batch 4)
                lens = torch.tensor([nk, nk * 3 // 5, 0, nk // 5 + 1][:b] if b > 1 else [nk * 2 // 3], device="cuda")
                mask = torch.arange(nk, device="cuda")[None] < lens[:, None]
            with torch.no_grad():
                out = flash_attention(q, k, v, kv_mask=mask)
                torch.cuda.synchronize()
                ref = sdpa(q, k, v, kv_mask=mask)
                err = (out.float() - ref.float()).abs().max().item()
                if not torch.isfinite(out).all():
                    fail(f"{name} {dt}: kernel output is not finite")
                ms = cuda_ms(lambda: flash_attention(q, k, v, kv_mask=mask))
                plain_ms = cuda_ms(lambda: sdpa(q, k, v, kv_mask=mask))
                attn_mask = None if mask is None else mask[:, None, None, :]
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
            # the work this run's data needs: masked keys take no product
            keys = b * nk if mask is None else int(mask.sum().item())
            flops = 4.0 * h * nq * keys * d
            b_ms, b_by = bound(q.element_size() * (2 * q.numel() + 2 * k.numel()), flops, dt)
            rec = dict(name=name, dtype=dt, shape=[b, h, nq, nk, d], masked=masked,
                       max_abs_err=err, bound=BOUNDS[dt], ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, tflops=flops / ms / 1e9)
            print(f"[kernel] {name:23s} {dt:4s} B,H,Nq,Nk,D={b},{h},{nq},{nk},{d} "
                  f"mask={masked!s:5s} max_abs_err={err:.3e} (bound {BOUNDS[dt]:.0e}) "
                  f"ms={ms:.4f} ({flops / ms / 1e9:.0f} TFLOP/s) sdpa_ms={plain_ms:.4f} "
                  f"torch_sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
            if not err <= BOUNDS[dt]:
                fail(f"{name} {dt}: kernel differs from sdpa by {err} > {BOUNDS[dt]}")
            records.append(rec)
            del q, k, v, out, ref
    return records


def backward_phase():
    """K2 (the dq and dk/dv kernels) and K1's log-sum-exp output against their
    plain versions at the shapes of a DMD train step (batch 2), a masked
    cross-attention and a ragged shape, bf16 and f32; the same inputs twice
    give the same bits. The yardstick is the backward (alone) of
    ``F.scaled_dot_product_attention`` through autograd. Returns (dq records,
    dk/dv records, K1-with-LSE records)."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import attention as A

    cases = [  # (name, (B, H, Nq, Nk, D), keys kept per sample or None)
        ("dit_self", (2, 16, 1024, 1024, 72), None),
        ("dit_cross", (2, 16, 1024, 300, 72), None),
        ("dit_cross_masked", (2, 16, 1024, 300, 72), (77, 300)),
        ("ragged", (1, 16, 1000, 77, 72), None),
    ]
    dq_records, dkv_records, lse_records = [], [], []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, (b, h, nq, nk, d), kept in cases:
        for dt in ("bf16", "f32"):
            dtype = getattr(torch, DTYPES[dt])
            q = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(b, h, nk, d, device="cuda", generator=gen).to(dtype)
            v = (torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1).to(dtype)
            do = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtype)
            mask = None
            if kept is not None:
                mask = torch.arange(nk, device="cuda")[None] < torch.tensor(kept, device="cuda")[:, None]
            scale = d**-0.5
            with torch.no_grad():
                o, lse = A._forward(q, k, v, mask, scale, want_lse=True)
                torch.cuda.synchronize()
                lse_err = max_err(lse, A.flash_lse_plain(q, k, mask, scale))
                o_err = max_err(o, A.sdpa(q, k, v, kv_mask=mask, scale=scale))
                di = (do.float() * o.float()).sum(-1)
                dq = A.flash_dq(q, k, v, mask, lse, di, do, scale)
                dk, dv = A.flash_dkv(q, k, v, mask, lse, di, do, scale)
                torch.cuda.synchronize()
                ref = A.flash_backward_plain(q, k, v, mask, o, lse, do, scale)
                errs, abs_errs = {}, {}
                for key, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                    if not torch.isfinite(got).all():
                        fail(f"flash backward {name} {dt}: {key} is not finite")
                    abs_errs[key] = max_err(got, want)
                    errs[key] = abs_errs[key] / want.float().abs().max().item()
                again = A.flash_backward(q, k, v, mask, o, lse, do, scale)
                same = all(torch.equal(x, y) for x, y in zip(again, (dq, dk, dv)))
                ms_fwd = cuda_ms(lambda: A._forward(q, k, v, mask, scale, want_lse=False))
                ms_lse = cuda_ms(lambda: A._forward(q, k, v, mask, scale, want_lse=True))
                ms_dq = cuda_ms(lambda: A.flash_dq(q, k, v, mask, lse, di, do, scale))
                ms_dkv = cuda_ms(lambda: A.flash_dkv(q, k, v, mask, lse, di, do, scale))
                ms_both = cuda_ms(lambda: A.flash_backward(q, k, v, mask, o, lse, do, scale))
                plain_ms = cuda_ms(lambda: A.flash_backward_plain(q, k, v, mask, o, lse, do, scale), iters=3, warmup=1)
                plain_lse_ms = cuda_ms(lambda: A.flash_lse_plain(q, k, mask, scale), iters=3, warmup=1)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            attn_mask = None if mask is None else mask[:, None, None, :]
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask)
            lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
            lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), iters=10)
            del lib_out, leaves
            # the work this run's data needs: masked keys take no product
            pairs = float(h * nq * (b * nk if mask is None else int(mask.sum().item())))
            es = q.element_size()
            b_dq = bound(es * (3 * q.numel() + 2 * k.numel()) + 8 * lse.numel(), 6.0 * pairs * d, dt)
            b_dkv = bound(es * (2 * q.numel() + 4 * k.numel()) + 8 * lse.numel(), 8.0 * pairs * d, dt)
            b_both = bound(es * (4 * q.numel() + 4 * k.numel()), 10.0 * pairs * d, dt)
            b_fwd = bound(es * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel(), 4.0 * pairs * d, dt)
            common = dict(name=name, dtype=dt, shape=[b, h, nq, nk, d], masked=mask is not None,
                          bound=BACKWARD_BOUNDS[dt], bitwise_repeat=same, plain_ms=plain_ms, library_ms=lib_ms,
                          together_ms=ms_both, together_bound_ms=b_both[0])
            # held to the relative error (of each output's largest magnitude); the absolute one beside it
            dq_records.append(dict(common, max_abs_err=abs_errs["dq"], max_rel_err=errs["dq"], ms=ms_dq,
                                   bound_ms=b_dq[0], bound_by=b_dq[1]))
            dkv_records.append(dict(common, max_abs_err=max(abs_errs["dk"], abs_errs["dv"]),
                                    max_rel_err=max(errs["dk"], errs["dv"]), rel_err={k: errs[k] for k in ("dk", "dv")},
                                    ms=ms_dkv, bound_ms=b_dkv[0], bound_by=b_dkv[1]))
            lse_records.append(dict(name=name, dtype=dt, shape=[b, h, nq, nk, d], masked=mask is not None,
                                    max_abs_err=lse_err, bound=LSE_BOUNDS[dt], out_max_abs_err=o_err, ms=ms_lse,
                                    ms_without_lse=ms_fwd, plain_ms=plain_lse_ms, library_ms=lib_fwd_ms,
                                    bound_ms=b_fwd[0], bound_by=b_fwd[1]))
            print(f"[backward] {name:17s} {dt:4s} B,H,Nq,Nk,D={b},{h},{nq},{nk},{d} mask={mask is not None!s:5s} "
                  f"rel_err dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e} (bound {BACKWARD_BOUNDS[dt]:.0e} of "
                  f"each output's largest magnitude) lse max_abs_err={lse_err:.3e} (bound {LSE_BOUNDS[dt]:.0e}) "
                  f"same bits twice={same} dq_ms={ms_dq:.4f} (bound {b_dq[0]:.4f}) dkv_ms={ms_dkv:.4f} (bound {b_dkv[0]:.4f}) "
                  f"dq+dkv+di_ms={ms_both:.4f} (bound {b_both[0]:.4f}, {b_both[1]}) plain_ms={plain_ms:.4f} "
                  f"torch_sdpa_backward_ms={lib_ms:.4f}; forward ms={ms_fwd:.4f}, with lse {ms_lse:.4f}", flush=True)
            if not max(errs.values()) <= BACKWARD_BOUNDS[dt]:
                fail(f"flash backward {name} {dt}: differs from the plain version by {errs} > {BACKWARD_BOUNDS[dt]}")
            if not lse_err <= LSE_BOUNDS[dt] or not o_err <= BOUNDS[dt]:
                fail(f"flash forward with lse {name} {dt}: lse differs by {lse_err}, the output by {o_err}")
            if not same:
                fail(f"flash backward {name} {dt}: two runs on the same inputs differ")
            del q, k, v, do, o, lse, di, dq, dk, dv, ref, again

    # a sample whose keys are all masked: the flag path, against autograd through the plain forward
    b, h, nq, nk, d = 2, 16, 256, 300, 72
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen) for n in (nq, nk, nk, nq))
    mask = torch.arange(nk, device="cuda")[None] < torch.tensor([0, 120], device="cuda")[:, None]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(A.sdpa(*leaves, kv_mask=mask), leaves, do)
    got = torch.autograd.grad(A.flash_attention(*leaves, kv_mask=mask), leaves, do)
    err = max(max_err(x, y) / y.abs().max().item() for x, y in zip(got, want))
    print(f"[backward] a sample with every key masked, f32, kernels through autograd against autograd through sdpa: "
          f"rel_err={err:.3e} (bound {BACKWARD_BOUNDS['f32']:.0e})", flush=True)
    if not err <= BACKWARD_BOUNDS["f32"]:
        fail(f"flash backward, fully masked sample: differs from autograd through sdpa by {err}")
    return dq_records, dkv_records, lse_records


def swin_phase():
    """K4 against its plain version (roll, partition, ``sdpa``, reverse, roll
    back) at every shape the main path, the CLI and the server give it, plus
    non-square maps and batch 1, shifted with the mask and unshifted without.
    Yardsticks: ``library_ms`` is one ``F.scaled_dot_product_attention`` call
    with the additive mask on already partitioned (B * nW, heads, 64, hd)
    tensors; ``library_composition_ms`` is the whole composition around that
    call (roll, partition, head split, the call, reverse, roll back). Returns
    per-shape records."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import window as W
    from instarevive_tpu_torch.ops.swin_attention import swin_window_attention, swin_window_attention_plain

    heads, hd, win = 6, 30, 8
    c, n, scale = heads * hd, win * win, hd**-0.5
    cases = [  # (name, (B, H, W), dtypes)
        ("process_b4_64x64", (4, 64, 64), ("bf16", "f32")),
        ("tiled_b1_128x128", (1, 128, 128), ("bf16", "f32")),
        ("one_512_b1_64x64", (1, 64, 64), ("bf16", "f32")),
        ("serve_b2_64x64", (2, 64, 64), ("bf16",)),
        ("serve_b3_64x64", (3, 64, 64), ("bf16",)),
        ("serve_b1_64x80", (1, 64, 80), ("bf16",)),
        ("cli_b1_64x104", (1, 64, 104), ("bf16",)),
        ("nonsquare_b1_64x48", (1, 64, 48), ("bf16", "f32")),
        ("nonsquare_b2_64x48", (2, 64, 48), ("bf16",)),
        ("small_b2_16x16", (2, 16, 16), ("bf16", "f32")),
    ]
    records = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, (b, h, w), dts in cases:
        for dt in dts:
            for shift in (0, win // 2):
                dtype = getattr(torch, DTYPES[dt])
                qkv = torch.randn(b, h, w, 3 * c, device="cuda", generator=gen)
                qkv[..., 2 * c:] = torch.rand(b, h, w, c, device="cuda", generator=gen) * 2 - 1
                qkv = qkv.to(dtype)
                bias = 0.5 * torch.randn(heads, n, n, device="cuda", generator=gen)
                mask = torch.from_numpy(W.shift_attn_mask(h, w, win, shift)).cuda() if shift else None

                def split(x):  # today's route to the library call: roll, partition, head split
                    x = W.cyclic_shift(x, shift) if shift else x
                    return W.window_partition(x, win).reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)

                add = bias[None] if mask is None else (bias[None] + mask[:, None]).repeat(b, 1, 1, 1)
                add = add.to(dtype).expand(b * (h // win) * (w // win), heads, n, n)
                q, k, v = (t.contiguous() for t in split(qkv))

                def library():
                    return F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=scale)

                def library_composition():
                    o = F.scaled_dot_product_attention(*split(qkv), attn_mask=add, scale=scale)
                    o = W.window_reverse(o.transpose(1, 2).reshape(-1, n, c), win, h, w)
                    return W.cyclic_unshift(o, shift) if shift else o

                with torch.no_grad():
                    out = swin_window_attention(qkv, bias, mask, heads, win, scale, shift)
                    torch.cuda.synchronize()
                    ref = swin_window_attention_plain(qkv, bias, mask, heads, win, scale, shift)
                    ref32 = swin_window_attention_plain(qkv.float(), bias, mask, heads, win, scale, shift)
                    err, err32 = max_err(out, ref), max_err(out, ref32)
                    lib_err = max_err(library_composition(), ref32)
                    if not torch.isfinite(out).all():
                        fail(f"swin_window_attention {name} {dt} shift={shift}: kernel output is not finite")
                    ms = cuda_ms(lambda: swin_window_attention(qkv, bias, mask, heads, win, scale, shift), iters=50)
                    plain_ms = cuda_ms(lambda: swin_window_attention_plain(qkv, bias, mask, heads, win, scale, shift),
                                       iters=5, warmup=1)
                    lib_ms = cuda_ms(library, iters=10)
                    comp_ms = cuda_ms(library_composition, iters=10)
                windows = b * (h // win) * (w // win)
                nbytes = qkv.element_size() * (qkv.numel() + out.numel()) + 4 * (bias.numel() + (0 if mask is None else mask.numel()))
                b_ms, b_by = bound(nbytes, 4.0 * windows * heads * n * n * hd, dt)
                rec = dict(name=f"{name}_{'shifted' if shift else 'unshifted'}", dtype=dt, shape=[b, h, w, 3 * c],
                           shift=shift, masked=mask is not None, max_abs_err=err, bound=SWIN_BOUNDS[dt],
                           max_abs_err_vs_f32=err32, library_max_abs_err_vs_f32=lib_err, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_composition_ms=comp_ms, bound_ms=b_ms, bound_by=b_by,
                           gbytes_per_s=nbytes / ms / 1e6)
                print(f"[swin_attn] {rec['name']:30s} {dt:4s} B,H,W,3C={b},{h},{w},{3 * c} shift={shift} "
                      f"max_abs_err={err:.3e} (bound {SWIN_BOUNDS[dt]:.0e}) vs_f32_reference={err32:.3e} "
                      f"(library's {lib_err:.3e}) ms={ms:.4f} ({rec['gbytes_per_s']:.0f} GB/s) plain_ms={plain_ms:.4f} "
                      f"torch_sdpa_ms={lib_ms:.4f} with_partition_and_rolls_ms={comp_ms:.4f} "
                      f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
                if not err <= SWIN_BOUNDS[dt]:
                    fail(f"swin_window_attention {name} {dt} shift={shift}: kernel differs from the plain version "
                         f"by {err} > {SWIN_BOUNDS[dt]}")
                if dt == "bf16" and not err32 <= SWIN_F32_REF_BOUND:
                    fail(f"swin_window_attention {name} shift={shift}: bf16 kernel is {err32} from the f32 "
                         f"reference, over {SWIN_F32_REF_BOUND}")
                records.append(rec)
                del qkv, q, k, v, add, out, ref, ref32
    return records


def counters():
    """name -> wrapper; each wrapper's ``launches`` counts its kernel launches."""
    from instarevive_tpu_torch.ops.attention import flash_attention, flash_dkv, flash_dq
    from instarevive_tpu_torch.ops.filters import filter2d
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3
    from instarevive_tpu_torch.ops.norm_kernels import gn_affine, group_norm_silu, upsample2x_nearest
    from instarevive_tpu_torch.ops.swin_attention import swin_window_attention

    return {"flash_attn_fwd": flash_attention, "flash_attn_bwd_dq": flash_dq, "flash_attn_bwd_dkv": flash_dkv,
            "gn_silu_conv3x3": gn_silu_conv3x3, "gn_stats_fold": gn_affine,
            "gn_apply": group_norm_silu, "upsample2x": upsample2x_nearest,
            "swin_window_attention": swin_window_attention, "filter2d": filter2d}


# launched by training only: the attention backward, and the degradation's filter
BACKWARD_KERNELS = ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")
TRAIN_ONLY_KERNELS = BACKWARD_KERNELS + ("filter2d",)


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def expected_counts(pipe, dit_forwards: int, encodes: int, decodes: int, cleans: int = 1):
    """Launches the configuration implies: per SwinIR forward one window
    attention for every block and one upsample for every step of its
    upsampler; per VAE encode 2 fused convs for
    each of levels * blocks + 2 ResnetBlocks, per decode levels * (blocks + 1)
    + 2; one moments launch inside every fused conv and one for each of the
    two standalone norms of an encode or a decode, which also launch the
    apply kernel; levels - 1 upsamples per decode; attention twice per DiT
    block and once per VAE mid block. Inference launches no backward kernel
    and no degradation filter."""
    levels, blocks = len(pipe.vae.ch_mult), len(pipe.vae.encoder.down[0].block)
    convs = encodes * 2 * (levels * blocks + 2) + decodes * 2 * (levels * (blocks + 1) + 2)
    norms = 2 * (encodes + decodes)
    swin_blocks = sum(len(layer.residual_group.blocks) for layer in pipe.swinir.layers)
    return {"flash_attn_fwd": dit_forwards * 2 * pipe.dit.depth + encodes + decodes,
            "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0, "gn_silu_conv3x3": convs,
            "gn_stats_fold": convs + norms, "gn_apply": norms,
            "upsample2x": decodes * (levels - 1) + cleans * len(pipe.swinir.ups),
            "swin_window_attention": cleans * swin_blocks, "filter2d": 0}


def check_counts(what: str, pipe, dit_forwards: int, encodes: int, decodes: int, cleans: int = 1):
    got, want = read_counts(), expected_counts(pipe, dit_forwards, encodes, decodes, cleans)
    if got != want:
        fail(f"{what}: kernel launches {got}, expected {want}")
    return got


def small_pipeline_phase(cfg_full):
    """Full widths, cut depth: f32 on the card against f32 on the CPU."""
    import torch

    from instarevive_tpu_torch.config import merge
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params

    cfg = merge(cfg_full, {"swinir": {"depths": [2, 2], "num_heads": [6, 6]}, "dit": {"depth": 2}})
    cpu = init_params(build_pipeline(cfg, device="cpu"), seed=1)
    sd = cpu.state_dict()
    outs = {}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        gpu = build_pipeline(cfg, dtype=dtype, device="cuda")
        gpu.load_state_dict(sd)
        lq = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(3))
        y = cpu.dit.y_embedder.y_embedding[:300][None].repeat(2, 1, 1)
        reset_counts()
        outs[label] = gpu.process(lq.cuda(), y.cuda()).cpu()
        check_counts(f"small pipeline {label}", gpu, 1, 1, 1)
    ref = cpu.process(lq, y)
    err32 = (outs["f32"] - ref).abs().max().item()
    err16 = (outs["bf16"] - ref).abs().max().item()
    print(f"[small pipeline] 2x128x128, full widths, depth cut: card f32 vs CPU f32 "
          f"max_abs_err={err32:.3e} (bound {PIPELINE_F32_BOUND:.0e}); card bf16 vs CPU f32 "
          f"max_abs_err={err16:.3e} (not bounded)", flush=True)
    if not err32 <= PIPELINE_F32_BOUND:
        fail(f"small pipeline: card f32 differs from CPU f32 by {err32}")
    return err32, err16


def check_image(out, shape, what):
    import torch

    if tuple(out.shape) != shape:
        fail(f"{what}: shape {tuple(out.shape)} != {shape}")
    if not torch.isfinite(out).all():
        fail(f"{what}: output is not finite")
    if out.min().item() < 0.0 or out.max().item() > 1.0:
        fail(f"{what}: output outside [0, 1]")


def tally_shapes(call, what, conv_records, swin_records, key=None):
    """Run ``call`` with every kernel count at 0 and the window attention and
    (unless ``conv_records`` is None) the fused convolution tallying their
    launches by shape. Every shape the call gave a tallied kernel must be one
    its phase held against the plain version; with ``key``, the measured count
    goes into that record under it. Returns the call's output."""
    import torch

    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3
    from instarevive_tpu_torch.ops.swin_attention import swin_window_attention

    tallied = [(swin_window_attention, "(B, H, W, 3C, shift, masked)",
                {(*r["shape"], r["shift"], r["masked"]): r for r in swin_records if r["dtype"] == "bf16"})]
    if conv_records is not None:
        tallied.append((gn_silu_conv3x3, "(N, H, W, C, Co)",
                        {tuple(r["shape"]): r for r in conv_records if r["dtype"] == "bf16"}))
    reset_counts()
    for fn, _, _ in tallied:
        fn.shapes = {}
    try:
        out = call()
        torch.cuda.synchronize()
        seen = [fn.shapes for fn, _, _ in tallied]
    finally:
        for fn, _, _ in tallied:
            fn.shapes = None
    for (fn, legend, held), shapes in zip(tallied, seen):
        missing = sorted(set(shapes) - set(held))
        if missing:
            fail(f"{what}: {fn.__name__} ran at shapes its kernel phase did not hold: {missing}")
        if sum(shapes.values()) != fn.launches:
            fail(f"{what}: {fn.__name__}: {sum(shapes.values())} launches tallied by shape, {fn.launches} counted")
        if key is not None:
            for shape, rec in held.items():
                rec[key] = shapes.get(shape, 0)
        print(f"[pipeline] {what}: {fn.__name__} launches by {legend}: "
              + ", ".join(f"{k}x{v}" for k, v in sorted(shapes.items())), flush=True)
    return out


def pipeline_phase(conv_records, swin_records):
    import torch

    from instarevive_tpu_torch.pipelines.restore import tile_grid
    from instarevive_tpu_torch.tools.time_restore import build_v1, wall

    t0 = time.time()
    v1 = build_v1(REPO)
    torch.cuda.synchronize()
    print(f"[pipeline] built instarevive_v1 in bf16 with seeded random weights in {time.time() - t0:.1f}s", flush=True)
    b, size = v1.batch, v1.size

    out = tally_shapes(v1.process, "process", conv_records, swin_records, "launches_process")
    launches = check_counts("process", v1.pipe, 1, 1, 1)
    check_image(out, (b, size, size, 3), "process")
    torch.cuda.reset_peak_memory_stats()
    times = wall(v1.process, 3)
    sec = sorted(times)[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[pipeline] process 4x512x512: kernel launches={launches} (as the configuration implies), "
          f"warm s/batch={sec:.4f} (runs {', '.join(f'{t:.4f}' for t in times)}), "
          f"MP/s={b * size * size / 1e6 / sec:.3f}, peak allocated={peak:.2f} GiB", flush=True)

    tile, stride, large = v1.tile, v1.stride, v1.large
    n_tiles = len(tile_grid(large // 8, large // 8, tile // 8, stride // 8))
    out1 = tally_shapes(v1.process_tiled, "process_tiled", conv_records, swin_records, "launches_tiled")
    # SwinIR and one encode on the whole image, a DiT forward per 4 tiles, a decode per tile
    tiled_launches = check_counts("process_tiled", v1.pipe, -(-n_tiles // 4), 1, n_tiles)
    check_image(out1, (1, large, large, 3), "process_tiled")
    torch.cuda.reset_peak_memory_stats()
    sec1 = wall(v1.process_tiled, 1)[0]
    peak1 = torch.cuda.max_memory_allocated() / 2**30
    print(f"[pipeline] process_tiled 1x1024x1024 tile {tile}/{stride} ({n_tiles} tiles): "
          f"kernel launches={tiled_launches}, warm s={sec1:.4f}, MP/s={large * large / 1e6 / sec1:.3f}, "
          f"peak allocated={peak1:.2f} GiB", flush=True)
    del v1
    torch.cuda.empty_cache()
    return launches, tiled_launches


def cli_phase():
    import numpy as np
    from PIL import Image

    from instarevive_tpu_torch import inference

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        rng = np.random.default_rng(0)
        sizes = {"a": (256, 256), "b": (200, 320)}  # (h, w)
        for name, (h, w) in sizes.items():
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(os.path.join(src, f"{name}.png"))
        t = time.time()
        inference.main(["--input", src, "--output", dst, "--random_init", "--device", "cuda",
                        "--config", os.path.join(REPO, "configs", "instarevive_v1.yaml")])
        made = sorted(os.listdir(dst))
        if made != ["a.png", "b.png"]:
            fail(f"CLI wrote {made}, expected a.png and b.png")
        got = {n: Image.open(os.path.join(dst, f"{n}.png")).size for n in sizes}
        print(f"[cli] wrote {made} in {time.time() - t:.1f}s, sizes (w, h) {got}", flush=True)


def serve_phase(cfg_full, swin_records, process_launches):
    """The port's server in this process, through the pieces its ``main`` puts
    together. Full width in bf16: concurrent requests in two shape buckets,
    every answer checked, ``/healthz`` held to the requests sent. Then a
    depth-cut f32 server, one answer held against ``process`` called directly
    on the same prepared image. Between them, the demo's restorer
    (``interface.build_restorer``) on one image. ``process_launches`` is what
    one ``process`` call of the full model launches."""
    import base64
    import io
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from instarevive_tpu_torch import interface, serve
    from instarevive_tpu_torch.config import merge
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params
    from instarevive_tpu_torch.utils.image_io import prepare, png_bytes, to_uint8

    def post(url, png):
        body = json.dumps({"image": base64.b64encode(png).decode()}).encode()
        with urllib.request.urlopen(urllib.request.Request(url + "/restore", data=body), timeout=300) as r:
            return np.asarray(Image.open(io.BytesIO(base64.b64decode(json.loads(r.read())["image"]))).convert("RGB"))

    def health(url):
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            return json.loads(r.read())

    def serving(restore):
        batcher = serve.Batcher(restore, max_batch=4, batch_window_ms=30)
        server = serve.make_server(batcher, 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return batcher, server, thread, f"http://127.0.0.1:{server.server_address[1]}"

    def stop(batcher, server, thread):
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        batcher.close()
        if thread.is_alive() or batcher.stats()["ok"]:
            fail("serve: the server or its worker did not stop")

    rng = np.random.default_rng(0)
    sizes = [(512, 512)] * 8 + [(512, 640)]  # (h, w): eight of one bucket, one of another
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for h, w in sizes]
    pngs = [png_bytes(img) for img in images]

    args = serve.parse_args(["--config", os.path.join(REPO, "configs", "instarevive_v1.yaml"), "--random_init"])
    if (args.device, args.max_batch, args.batch_window_ms) != ("cuda", 4, 30):
        fail(f"serve: defaults are {args}")
    batcher, server, thread, url = serving(serve.build_restorer(args))
    try:
        post(url, pngs[0])  # warm: the first use of the bucket
        base = health(url)

        def burst():
            with ThreadPoolExecutor(len(pngs)) as pool:
                return list(pool.map(lambda png: post(url, png), pngs))  # an HTTP 500 or a timeout raises here

        t0 = time.perf_counter()
        answers = tally_shapes(burst, "serve", None, swin_records)  # batch sizes follow the arrivals
        seconds = time.perf_counter() - t0
        stats = health(url)
    finally:
        stop(batcher, server, thread)
    served, batches = stats["served"] - base["served"], stats["batches"] - base["batches"]
    for (h, w), out in zip(sizes, answers):
        if out.shape != (h, w, 3) or out.dtype != np.uint8 or out.std() == 0:
            fail(f"serve: a {h}x{w} request was answered with shape {out.shape}, std {out.std()}")
    if stats["errors"] or not stats["ok"] or served != len(pngs) or not batches < served:
        fail(f"serve: /healthz {stats} after {len(pngs)} requests (before them {base})")
    counts = read_counts()
    if any(v == 0 for name, v in counts.items() if name not in TRAIN_ONLY_KERNELS):
        fail(f"serve: a kernel was not launched while serving: {counts}")
    print(f"[serve] {card_line()}: instarevive_v1 bf16, {len(pngs)} concurrent POST /restore (8 of 512x512, 1 of "
          f"512x640) in {seconds:.3f}s = {len(pngs) / seconds:.2f} requests/s, PNG coding included; {batches} batches, "
          f"mean batch size {served / batches:.2f}; kernel launches {counts}", flush=True)
    torch.cuda.empty_cache()

    # the demo's restorer, as its entry point builds it: the same flags, one image at a time
    demo = interface.build_restorer(interface.parse_args(["--config", args.config, "--random_init"]))
    reset_counts()
    restored = demo(images[-1], "adain")
    if read_counts() != process_launches:  # one process call, whatever the batch
        fail(f"interface: kernel launches {read_counts()}, expected {process_launches}")
    if restored.size != images[-1].size or np.asarray(restored).std() == 0:
        fail(f"interface: a {images[-1].size} image came back as {restored.size}")
    print(f"[serve] interface.build_restorer on the card: {images[-1].size} -> {restored.size} (w, h), adain color fix",
          flush=True)
    del demo
    torch.cuda.empty_cache()

    cfg = merge(cfg_full, {"swinir": {"depths": [2, 2], "num_heads": [6, 6]}, "dit": {"depth": 2}})
    pipe = init_params(build_pipeline(cfg, device="cuda"), seed=1)
    y = pipe.dit.y_embedder.y_embedding[: pipe.dit.model_max_length][None].float()
    batcher, server, thread, url = serving(serve.make_restorer(pipe, y))
    try:
        reset_counts()
        got = post(url, pngs[-1])
        small_counts = check_counts("serve, depth-cut f32", pipe, 1, 1, 1)
        stats = health(url)
    finally:
        stop(batcher, server, thread)
    x, th, tw = prepare(images[-1])
    want = to_uint8(pipe.process(torch.from_numpy(x[None]).cuda(), y)[0, :th, :tw].cpu().numpy())
    levels = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    print(f"[serve] depth-cut f32 server, one 512x640 request against process called directly: "
          f"max difference {levels} of 255 levels (bound 1); kernel launches {small_counts}; /healthz {stats}", flush=True)
    if got.shape != want.shape or levels > 1 or stats["served"] != 1 or stats["errors"]:
        fail(f"serve: the served answer differs from process by {levels} levels (shapes {got.shape}, {want.shape})")
    return len(pngs) / seconds, served / batches


def train_phase(cfg_full):
    """The trainer through its entry point (``train.launcher.main``, what
    ``python -m instarevive_tpu_torch.train`` runs) at full XL-2 width in bf16
    from f32 masters, batch 2 at 512x512, every block checkpointed: 3 steps,
    then 1 more from the checkpoint it wrote. Then timed steps on the resumed
    task, ``--lowmem`` once at depth 2, and one depth-2 f32 step on the card
    against the CPU. Returns (launches of the 3-step run, launches per step,
    the timing record)."""
    import gc

    import numpy as np
    import torch
    import yaml

    from instarevive_tpu_torch.config import merge
    from instarevive_tpu_torch.pipelines.build import build_pipeline, cast_weights, init_params
    from instarevive_tpu_torch.tools import time_train as T
    from instarevive_tpu_torch.train import launcher

    def finite(run, what):
        for i, m in enumerate(run.history):
            if set(m) != {"regression", "dm", "loss", "fake_score"} or not all(np.isfinite(v) for v in m.values()):
                fail(f"{what}: metrics of step {run.start_step + i} are {m}")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # the initialisation every run below starts from (the launcher's default seed), in f32 and as the
    # frozen teacher holds it (bf16 weights under --bf16)
    init = init_params(build_pipeline(cfg_full, dtype=torch.bfloat16, device="cuda", dit_master_weights=True), seed=0).dit
    init_f32 = [p.detach().clone() for p in init.parameters()]
    init_teacher = [p.detach().clone() for p in cast_weights(init, torch.bfloat16).parameters()]
    del init
    free()

    def teacher_is_as_initialised(task):
        return all(torch.equal(a, b) for a, b in zip(init_teacher, task.teacher.parameters()))

    depth = cfg_full["dit"]["depth"]
    per_step = dict.fromkeys(counters(), 0)
    per_step.update(T.expected_launches(depth, grad_checkpoint=True))
    # the encode, as expected_counts reckons it for the restoration path
    levels, blocks = len(cfg_full["vae"]["ch_mult"]), cfg_full["vae"]["num_res_blocks"]
    per_step.update(gn_silu_conv3x3=2 * (levels * blocks + 2), gn_stats_fold=2 * (levels * blocks + 2) + 2, gn_apply=2)
    config = os.path.join(REPO, "configs", "instarevive_v1.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        data = T.write_images(os.path.join(tmp, "hq"))
        null = os.path.join(tmp, "null.npy")  # a null caption that differs from the zero caption: guidance has a gap
        np.save(null, np.random.default_rng(1).standard_normal((300, 4096)).astype(np.float32) * 4096**-0.5)
        out = os.path.join(tmp, "run")
        extra = ["--null_embed", null]

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        run = launcher.main(T.train_argv(config, data, out, 3, extra))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite(run, "train")
        if (run.start_step, run.end_step, len(run.history)) != (0, 3, 3):
            fail(f"train: ran steps {run.start_step}..{run.end_step} with {len(run.history)} metric records")
        task = run.task
        # the loop degrades every batch before the DMD step reads its clean image: K6 as the draws imply
        want = dict({k: 3 * v for k, v in per_step.items()}, filter2d=task.degrade.filter_calls)
        if counts != want or not 6 <= counts["filter2d"] <= 9:
            fail(f"train: kernel launches of 3 steps {counts}, the configuration and the draws imply {want}")
        gen_state, fake_state = task.states
        if not task.gen.grad_checkpoint or any(p.dtype != torch.float32 for p in gen_state.params):
            fail("train: the generator is not checkpointed with f32 master weights")
        moved = {name: sum(not torch.equal(p, t) for p, t in zip(m.parameters(), init_f32))
                 for name, m in (("generator", task.gen), ("fake score", task.fake))}
        n_params = len(gen_state.params)
        if min(moved.values()) < n_params // 2:
            fail(f"train: of {n_params} parameter tensors only {moved} moved")
        if all(torch.equal(e, p) for e, p in zip(gen_state.ema_params, gen_state.params)):
            fail("train: the EMA equals the parameters")
        if any(p.requires_grad or p.grad is not None for p in task.teacher.parameters()) or not teacher_is_as_initialised(task):
            fail("train: the teacher takes gradients or moved")
        last = run.history[-1]
        print(f"[train] {card_line()}: instarevive_v1 at full width (depth {depth}), bf16 compute from f32 masters, "
              f"batch {T.BATCH} at {T.CROP}x{T.CROP}, checkpointed: 3 steps through train.launcher.main in {seconds:.1f}s "
              f"(set-up, first-use builds and the {os.path.getsize(os.path.join(out, 'final', 'state.pt')) / 2**30:.1f} GiB "
              f"checkpoint included); launches per step {({k: v for k, v in per_step.items() if v})} as the configuration "
              f"implies, filter2d {counts['filter2d']} in the 3 degradations as their draws imply; last step {({k: round(v, 6) for k, v in last.items()})}; {moved} of {n_params} parameter "
              f"tensors moved, the teacher is as initialised; peak allocated {peak:.2f} GiB", flush=True)
        del run, task, gen_state, fake_state
        free()

        reset_counts()
        again = launcher.main(T.train_argv(config, data, out, 4, extra + ["--resume", os.path.join(out, "final")]))
        finite(again, "train, resumed")
        if (again.start_step, again.end_step, len(again.history)) != (3, 4, 1) \
                or read_counts() != dict(per_step, filter2d=again.task.degrade.filter_calls):
            fail(f"train, resumed: ran steps {again.start_step}..{again.end_step}, launches {read_counts()}")
        if again.task.states[0].step != 4 or again.task.states[0].opt_state["inner"]["count"] != 4:
            fail("train, resumed: the restored state did not continue at step 3")
        if not teacher_is_as_initialised(again.task):
            fail("train, resumed: the teacher moved")
        print(f"[train] resumed from 'final' at step 3, took 1 step with the same launches: {again.history[-1]}", flush=True)

        timing = T.time_steps(again.task, T.load_batches(data, 3))
        if timing["launches_per_step"] != T.expected_launches(depth):
            fail(f"train: timed steps launched {timing['launches_per_step']}")
        print(f"[train] warm s/step {timing['step_median_s']:.4f} (steps {', '.join(f'{t:.4f}' for t in timing['step_s'])}); "
              "split, median ms by CUDA events: " + ", ".join(f"{k} {v:.1f}" for k, v in timing["phase_median_ms"].items())
              + f"; peak allocated {timing['peak_allocated_gib']:.2f} GiB", flush=True)
        del again
        free()

        # --lowmem (bf16 moments, EMA and teacher) once, at depth 2
        small = os.path.join(tmp, "depth2.yaml")
        with open(small, "w") as f:
            yaml.safe_dump(merge(cfg_full, {"dit": {"depth": 2}}), f)
        reset_counts()
        low = launcher.main(T.train_argv(small, data, os.path.join(tmp, "low"), 2, extra + ["--lowmem"]))
        finite(low, "train --lowmem")
        state = low.task.states[0]
        dtypes = {state.opt_state["inner"]["mu"][0].dtype, state.ema_params[0].dtype,
                  low.task.teacher.blocks[0].attn.qkv.weight.dtype}
        want = {k: 2 * v for k, v in T.expected_launches(2).items()}
        got = {k: v for k, v in read_counts().items() if k in want}
        if dtypes != {torch.bfloat16} or got != want:
            fail(f"train --lowmem at depth 2: state dtypes {dtypes}, launches {got} (expected {want})")
        print(f"[train] --lowmem at depth 2: 2 steps, bf16 moments, EMA and teacher; last step {low.history[-1]}", flush=True)
        del low, state
        free()

        err = train_step_card_against_cpu(cfg_full, data, null)
    return counts, per_step, dict(timing, three_steps_s=seconds, peak_allocated_first_run_gib=peak, card_vs_cpu=err)


def train_step_card_against_cpu(cfg_full, data, null):
    """One ``make_dmd_train_step`` at DiT depth 2, full width, f32, on the card
    and on the CPU: the same weights, batch and draws (made on the CPU and
    handed in). Losses and the gradients of both models are held to
    TRAIN_F32_BOUND, each gradient against its model's largest magnitude."""
    import torch

    from instarevive_tpu_torch.config import merge
    from instarevive_tpu_torch.tools import time_train as T
    from instarevive_tpu_torch.train import launcher

    cfg = merge(cfg_full, {"swinir": {"depths": [2, 2], "num_heads": [6, 6]}, "dit": {"depth": 2}})
    argv = [a for a in T.train_argv("-", data, "-", 1, ["--null_embed", null]) if a != "--bf16"]
    args = launcher.parse_args(argv)
    cpu = launcher.DMDTask(args, cfg, torch.device("cpu"))
    gpu = launcher.DMDTask(args, cfg, torch.device("cuda"))
    for name in ("gen", "fake", "teacher"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    gen = torch.Generator().manual_seed(5)
    shape = (T.BATCH, T.CROP // 8, T.CROP // 8, 4)
    batch = {"noise": torch.randn(shape, generator=gen), "latent": 0.5 * torch.randn(shape, generator=gen)}
    y = torch.randn(T.BATCH, 300, 4096, generator=gen) * 4096**-0.5
    draws = {"t_dm": torch.randint(20, 979, (T.BATCH,), generator=gen), "noise_dm": torch.randn(shape, generator=gen),
             "t_fake": torch.randint(0, 1000, (T.BATCH,), generator=gen), "noise_fake": torch.randn(shape, generator=gen)}
    out = {}
    for label, task in (("cpu", cpu), ("cuda", gpu)):
        kept = {}
        to = lambda d: {k: v.to(task.device) for k, v in d.items()}  # noqa: E731
        reset_counts()
        metrics = task._step(*task.states, to(batch), None, {"y": y.to(task.device)}, draws=to(draws), keep_grads=kept)
        out[label] = ({k: float(v) for k, v in metrics.items()}, {k: [g.cpu() for g in v] for k, v in kept.items()})
    got = {k: v for k, v in read_counts().items() if k in T.expected_launches(2)}
    if got != T.expected_launches(2, encodes=0):
        fail(f"train step, card against CPU: launches {got}")
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out["cuda"]
    errs = {f"metric {k}": abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12) for k in m_cpu}
    for which in ("generator", "fake"):
        top = max(g.abs().max().item() for g in g_cpu[which])
        errs[f"grad {which}"] = max((a - b).abs().max().item() for a, b in zip(g_gpu[which], g_cpu[which])) / top
    print(f"[train] one f32 step at depth 2, full width, card against CPU (same weights, batch, draws): metrics on the "
          f"CPU {m_cpu}; relative differences " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {TRAIN_F32_BOUND:.0e})", flush=True)
    if m_cpu["dm"] < 1e-8:
        fail("train step, card against CPU: the distribution-matching term is not exercised")
    if not max(errs.values()) <= TRAIN_F32_BOUND:
        fail(f"train step: the card differs from the CPU by {errs}")
    return errs


# Both degradation programs, the card against the CPU under one set of
# handed-in draws and CPU noise fields: JPEG rounding and the final 8-bit
# rounding flip on f32 noise, so the bound is statistical, as in the CPU
# parity tests: within one 8-bit level on at least 99% of pixels, mean
# absolute difference under 2e-3.
DEGRADE_LEVEL_SHARE, DEGRADE_MEAN_BOUND = 0.99, 2e-3
# One f32 SwinIR train step at depth 2x2, card against CPU: the loss relative
# to itself, every gradient against the largest gradient magnitude.
SWINIR_TRAIN_F32_BOUND = 1e-3


def held_filter_shapes(filter_records):
    return {(*r["shape"], *r["taps"], r["per_sample"]) for r in filter_records}


def degrade_phase(filter_records):
    """Both degradation programs on a seeded (2, 512, 512, 3) batch on the
    card. Returns (K6 launches of the counted calls by program, timing
    records by program)."""
    import statistics

    import torch

    from instarevive_tpu_torch.data import codeformer, realesrgan
    from instarevive_tpu_torch.ops.filters import filter2d
    from instarevive_tpu_torch.tools import time_degrade as D

    hq = D.clean_batch()
    held = held_filter_shapes(filter_records)
    launches, timing = {}, {}
    for kind in ("realesrgan", "codeformer"):
        call, cfg, gens = D.degradation_setup(kind, seed=0)
        call(hq)  # first use
        torch.cuda.synchronize()
        calls = 8 if kind == "realesrgan" else 3
        reset_counts()
        filter2d.shapes = {}
        expected, seen_blur2 = 0, set()
        try:
            for _ in range(calls):
                if kind == "realesrgan":
                    draws = realesrgan.draw_degradation(gens.host, cfg, hq.shape[0])
                    expected += 2 + int(draws.blur2)
                    seen_blur2.add(draws.blur2)
                else:
                    draws = codeformer.draw_codeformer(gens.host, cfg, hq.shape[0])
                    expected += 1
                out = call(hq, draws)
                torch.cuda.synchronize()
                check_image(out["lq"], tuple(hq.shape), f"degrade {kind}")
                if not torch.equal(out["hq"], hq * 2.0 - 1.0):
                    fail(f"degrade {kind}: hq is not 2 x - 1 of the clean batch")
                if (out["lq"] - hq).abs().mean().item() < 0.01:
                    fail(f"degrade {kind}: lq is the clean batch")
                if kind == "realesrgan" and (out["lq"] * 255 - torch.round(out["lq"] * 255)).abs().max().item() > 1e-4:
                    fail("degrade realesrgan: lq is not on 8-bit levels")
            shapes = filter2d.shapes
        finally:
            filter2d.shapes = None
        counts = read_counts()
        if counts["filter2d"] != expected or sum(shapes.values()) != expected or any(
                v for k, v in counts.items() if k != "filter2d"):
            fail(f"degrade {kind}: kernel launches {counts}, the draws imply filter2d {expected} and nothing else")
        if set(shapes) - held:
            fail(f"degrade {kind}: filter2d ran at shapes its kernel phase did not hold: {sorted(set(shapes) - held)}")
        launches[kind] = expected

        # the same seed twice: the same bits; another seed: another pair
        pairs = [D.degradation_setup(kind, seed=seed)[0](hq)["lq"] for seed in (5, 5, 6)]
        if not torch.equal(pairs[0], pairs[1]) or torch.equal(pairs[0], pairs[2]):
            fail(f"degrade {kind}: seeded calls do not repeat, or two seeds gave one pair")

        # the card against the CPU, one set of draws and noise fields
        gen = torch.Generator().manual_seed(9)
        if kind == "realesrgan":
            draws = D.forced_gaussian(realesrgan.draw_degradation(gen, cfg, hq.shape[0]),
                                      ((2, 768, 768, 3), (2, 160, 160, 3)), gen)
            run = lambda x, d: realesrgan.degrade_batch(None, x, cfg, draws=d)  # noqa: E731
        else:
            draws = codeformer.draw_codeformer(gen, cfg, hq.shape[0])
            draws.fields = (torch.randn(2, 128, 128, 3, generator=gen), torch.randn(2, 128, 128, 1, generator=gen))
            run = lambda x, d: codeformer.degrade_batch_codeformer(None, x, cfg, draws=d)  # noqa: E731
        diff = (run(hq, D.draws_on(draws, "cuda"))["lq"].cpu() - run(hq.cpu(), draws)["lq"]).abs()
        share, mean = (diff <= 1 / 255 + 1e-6).float().mean().item(), diff.mean().item()
        if not (share >= DEGRADE_LEVEL_SHARE and mean < DEGRADE_MEAN_BOUND):
            fail(f"degrade {kind}: card against CPU: {share:.5f} of pixels within one level, mean difference {mean:.2e}")

        walls = D.wall(lambda: call(hq), 10)
        split = D.split_ms(kind, call, hq, 10)
        timing[kind] = dict(wall_s=walls, wall_median_s=statistics.median(walls), split_median_ms=split)
        print(f"[degrade] {card_line()}: {kind} on (2, 512, 512, 3): {calls} calls, filter2d launches {expected} as the draws "
              f"imply" + (f" (second blur drawn {sorted(seen_blur2)})" if kind == "realesrgan" else "")
              + f", by (B, H, W, C, kh, kw, per-sample): {sorted(shapes.items())}, all held in the kernel phase; same seed "
              f"same bits; card against CPU with handed-in draws: {share:.5f} of pixels within one 8-bit level, mean "
              f"difference {mean:.2e} (bounds {DEGRADE_LEVEL_SHARE}, {DEGRADE_MEAN_BOUND:.0e}); warm wall "
              f"{statistics.median(walls) * 1e3:.2f} ms a call (median of 10); split, median ms by CUDA events: "
              + ", ".join(f"{k} {v:.2f}" for k, v in split.items()), flush=True)
    return launches, timing


def swinir_train_phase(cfg_full, swin_records, filter_records):
    """The trainer with ``--task swinir`` through its entry point at the full
    v1 SwinIR width (embed 180, 8 x 6 blocks) in bf16 from f32 masters, batch
    2 at 512x512: 3 steps, then 1 more from the checkpoint; K4 once a block,
    K5c once a step of the upsampler and K6 as the draws imply, per step, all
    in the forward (their backward is the plain version's). Then timed steps,
    and one depth-cut f32 step on the card against the CPU. Returns (launches
    of the 3-step run, launches per step without K6, the timing record)."""
    import gc

    import numpy as np
    import torch

    from instarevive_tpu_torch.config import merge
    from instarevive_tpu_torch.data import realesrgan
    from instarevive_tpu_torch.ops.filters import filter2d
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params
    from instarevive_tpu_torch.tools import time_degrade as D
    from instarevive_tpu_torch.tools import time_train as T
    from instarevive_tpu_torch.train import launcher

    blocks = sum(cfg_full["swinir"]["depths"])
    per_step = dict(dict.fromkeys(counters(), 0), swin_window_attention=blocks, upsample2x=3)
    init = init_params(build_pipeline(cfg_full, device="cuda", components=("swinir",)), seed=0).swinir
    init_params_f32 = [p.detach().clone() for p in init.parameters()]
    del init
    held = held_filter_shapes(filter_records)
    config = os.path.join(REPO, "configs", "instarevive_v1.yaml")

    def finite(run, what):
        for i, m in enumerate(run.history):
            if set(m) != {"loss", "grads_finite"} or not np.isfinite(m["loss"]) or m["grads_finite"] != 1.0:
                fail(f"{what}: metrics of step {run.start_step + i} are {m}")

    with tempfile.TemporaryDirectory() as tmp:
        data = T.write_images(os.path.join(tmp, "hq"))
        out = os.path.join(tmp, "run")
        filter2d.shapes = {}
        try:
            t0 = time.perf_counter()
            run = tally_shapes(lambda: launcher.main(T.train_argv(config, data, out, 3, task="swinir")),
                               "train swinir", None, swin_records)
            seconds = time.perf_counter() - t0
            shapes = filter2d.shapes
        finally:
            filter2d.shapes = None
        counts = read_counts()
        finite(run, "train swinir")
        task = run.task
        want = dict({k: 3 * v for k, v in per_step.items()}, filter2d=task.degrade.filter_calls)
        if (run.start_step, run.end_step, len(run.history)) != (0, 3, 3) or counts != want or not 6 <= counts["filter2d"] <= 9:
            fail(f"train swinir: ran steps {run.start_step}..{run.end_step}; kernel launches {counts}, the configuration "
                 f"and the draws imply {want}")
        if set(shapes) - held or sum(shapes.values()) != counts["filter2d"]:
            fail(f"train swinir: filter2d ran at shapes its kernel phase did not hold: {sorted(set(shapes) - held)}")
        (state,) = task.states
        moved = sum(not torch.equal(p, q) for p, q in zip(state.params, init_params_f32))
        tables = [p for n, p in zip(state.names, state.params) if n.endswith("relative_position_bias_table")]
        tables_moved = sum(not torch.equal(p, q) for (n, p), q in zip(zip(state.names, state.params), init_params_f32)
                           if n.endswith("relative_position_bias_table"))
        if any(p.dtype != torch.float32 for p in state.params) or moved < len(state.params) - 2 or tables_moved != len(tables):
            fail(f"train swinir: of {len(state.params)} f32 parameter tensors {moved} moved, of {len(tables)} bias tables "
                 f"{tables_moved}")
        if all(torch.equal(e, p) for e, p in zip(state.ema_params, state.params)):
            fail("train swinir: the EMA equals the parameters")
        print(f"[train swinir] {card_line()}: SwinIR at full v1 width (embed {cfg_full['swinir']['embed_dim']}, {blocks} "
              f"blocks), bf16 compute from f32 masters, batch {T.BATCH} at {T.CROP}x{T.CROP}: 3 steps through "
              f"train.launcher.main in {seconds:.1f}s (set-up and checkpoint included); launches per step "
              f"{({k: v for k, v in per_step.items() if v})} as the configuration implies, filter2d {counts['filter2d']} in "
              f"the 3 degradations as their draws imply, by shape {sorted(shapes.items())}; losses "
              f"{[round(m['loss'], 6) for m in run.history]}; {moved} of {len(state.params)} parameter tensors and all "
              f"{len(tables)} bias tables moved", flush=True)
        del run, task, state, tables
        gc.collect()
        torch.cuda.empty_cache()

        reset_counts()
        again = launcher.main(T.train_argv(config, data, out, 4, ["--resume", os.path.join(out, "final")], task="swinir"))
        finite(again, "train swinir, resumed")
        if (again.start_step, again.end_step, len(again.history)) != (3, 4, 1) \
                or read_counts() != dict(per_step, filter2d=again.task.degrade.filter_calls) \
                or again.task.states[0].step != 4 or again.task.states[0].opt_state["inner"]["count"] != 4:
            fail(f"train swinir, resumed: ran steps {again.start_step}..{again.end_step}, launches {read_counts()}")
        print(f"[train swinir] resumed from 'final' at step 3, took 1 step with the same launches: {again.history[-1]}",
              flush=True)

        timing = T.time_steps(again.task, T.load_batches(data, 5), T.SWINIR_PHASES)
        print(f"[train swinir] warm s/step {timing['step_median_s']:.4f} (steps {', '.join(f'{t:.4f}' for t in timing['step_s'])}); "
              "split, median ms by CUDA events: " + ", ".join(f"{k} {v:.1f}" for k, v in timing["phase_median_ms"].items())
              + f"; peak allocated {timing['peak_allocated_gib']:.2f} GiB", flush=True)
        del again
        gc.collect()
        torch.cuda.empty_cache()

        # one f32 step at depth 2 x 2: the same weights, loader batch and draws on the card and on the CPU
        cfg = merge(cfg_full, {"swinir": {"depths": [2, 2], "num_heads": [6, 6]}})
        argv = [a for a in T.train_argv("-", data, "-", 1, task="swinir") if a != "--bf16"]
        args = launcher.parse_args(argv)
        cpu, gpu = launcher.SwinIRTask(args, cfg, torch.device("cpu")), launcher.SwinIRTask(args, cfg, torch.device("cuda"))
        gpu.model.load_state_dict(cpu.model.state_dict())
        batch = T.load_batches(data, 1)[0]
        gen = torch.Generator().manual_seed(4)
        draws = D.forced_gaussian(realesrgan.draw_degradation(gen, cpu.degrade.cfg, T.BATCH),
                                  ((T.BATCH, 768, 768, 3), (T.BATCH, 160, 160, 3)), gen)
        res = {}
        for label, task, d in (("cpu", cpu, draws), ("cuda", gpu, D.draws_on(draws, "cuda"))):
            kept = []
            data_pair = task.degrade(torch.from_numpy(batch["hq"]).to(task.device).float() / 255.0, d)
            reset_counts()
            metrics = task.train_step(data_pair, keep_grads=kept)
            res[label] = (float(metrics["loss"]), [g.cpu() for g in kept])
        small = dict(dict.fromkeys(counters(), 0), swin_window_attention=4, upsample2x=3)
        if read_counts() != small:
            fail(f"train swinir step, card against CPU: launches {read_counts()}, expected {small}")
        (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res["cuda"]
        top = max(g.abs().max().item() for g in g_cpu)
        errs = {"loss": abs(l_gpu - l_cpu) / l_cpu, "grad": max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu)) / top}
        print(f"[train swinir] one f32 step at depth 2x2, full width, card against CPU (same weights, loader batch and "
              f"handed-in draws, each device degrading for itself): loss on the CPU {l_cpu:.6f}; relative differences "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (bound {SWINIR_TRAIN_F32_BOUND:.0e})", flush=True)
        if not max(errs.values()) <= SWINIR_TRAIN_F32_BOUND:
            fail(f"train swinir step: the card differs from the CPU by {errs}")
    return counts, per_step, dict(timing, three_steps_s=seconds, card_vs_cpu=errs)


# The UNet's and the ControlNet's attention at head dim 64 (configs/cldm.yaml at
# batch 2 on 512x512 crops: 64x64 latents, heads = channels / 64): self-attention
# at ds 1, 2, 4 and in the middle block, and cross-attention over the trainer's
# 4-key zero context and over a 77-key CLIP context, one with a ragged mask.
D64_CASES = [  # (name, (B, H, Nq, Nk), keys kept per sample or None)
    ("ds1_self", (2, 5, 4096, 4096), None),
    ("ds1_cross4", (2, 5, 4096, 4), None),
    ("ds1_cross77", (2, 5, 4096, 77), None),
    ("ds1_cross77_masked", (2, 5, 4096, 77), (77, 20)),
    ("ds2_self", (2, 10, 1024, 1024), None),
    ("ds2_cross4", (2, 10, 1024, 4), None),
    ("ds2_cross77", (2, 10, 1024, 77), None),
    ("ds4_self", (2, 20, 256, 256), None),
    ("ds4_cross4", (2, 20, 256, 4), None),
    ("ds4_cross77", (2, 20, 256, 77), None),
    ("mid_self", (2, 20, 64, 64), None),
    ("mid_cross4", (2, 20, 64, 4), None),
    ("mid_cross77", (2, 20, 64, 77), None),
    ("ragged_q1000_k40_masked", (1, 5, 1000, 40), (33,)),  # ragged Nq, Nk under one key tile
]


def d64_phase():
    """K1 (without and with the log-sum-exp) and K2 (dq, dk/dv) at head dim
    64 against ``sdpa``, ``flash_lse_plain`` and ``flash_backward_plain`` at
    every UNet / ControlNet shape, bf16 and f32: every output relative to its
    largest magnitude (BACKWARD_BOUNDS, as at head dim 72; q, k, dO randn and
    v in [-1, 1]), the log-sum-exp to LSE_BOUNDS, the same bits twice. The
    yardsticks are ``F.scaled_dot_product_attention``: the forward alone, and
    the forward plus the backward through autograd. Returns (forward records,
    dq records, dk/dv records, the bf16 shapes held as (B, H, Nq, Nk, 64,
    masked))."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import attention as A

    fwd_records, dq_records, dkv_records, held = [], [], [], set()
    gen = torch.Generator(device="cuda").manual_seed(64)
    d = 64
    for name, (b, h, nq, nk), kept in D64_CASES:
        for dt in ("bf16", "f32"):
            dtype = getattr(torch, DTYPES[dt])
            q = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(b, h, nk, d, device="cuda", generator=gen).to(dtype)
            v = (torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1).to(dtype)
            do = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtype)
            mask = None
            if kept is not None:
                mask = torch.arange(nk, device="cuda")[None] < torch.tensor(kept, device="cuda")[:, None]
            scale = d**-0.5
            iters = 20 if dt == "bf16" else 5
            with torch.no_grad():
                o, lse = A._forward(q, k, v, mask, scale, want_lse=True)
                o_plain_path = A._forward(q, k, v, mask, scale, want_lse=False)[0]
                torch.cuda.synchronize()
                ref = A.sdpa(q, k, v, kv_mask=mask, scale=scale)
                o_err = max_err(o_plain_path, ref)
                o_rel = o_err / ref.float().abs().max().item()
                lse_err = max_err(lse, A.flash_lse_plain(q, k, mask, scale))
                same_out = torch.equal(o, o_plain_path)
                got = A.flash_backward(q, k, v, mask, o, lse, do, scale)
                torch.cuda.synchronize()
                want = A.flash_backward_plain(q, k, v, mask, o, lse, do, scale)
                rel, abs_err = {}, {}
                for key, x, y in zip(("dq", "dk", "dv"), got, want):
                    if not torch.isfinite(x).all():
                        fail(f"head dim 64 {name} {dt}: {key} is not finite")
                    abs_err[key] = max_err(x, y)
                    rel[key] = abs_err[key] / y.float().abs().max().item()
                same = all(torch.equal(x, y) for x, y in zip(got, A.flash_backward(q, k, v, mask, o, lse, do, scale)))
                di = (do.float() * o.float()).sum(-1)
                ms_fwd = cuda_ms(lambda: A._forward(q, k, v, mask, scale, want_lse=False), iters=iters)
                ms_lse = cuda_ms(lambda: A._forward(q, k, v, mask, scale, want_lse=True), iters=iters)
                ms_dq = cuda_ms(lambda: A.flash_dq(q, k, v, mask, lse, di, do, scale), iters=iters)
                ms_dkv = cuda_ms(lambda: A.flash_dkv(q, k, v, mask, lse, di, do, scale), iters=iters)
                ms_both = cuda_ms(lambda: A.flash_backward(q, k, v, mask, o, lse, do, scale), iters=iters)
                plain_fwd_ms = cuda_ms(lambda: A.sdpa(q, k, v, kv_mask=mask, scale=scale), iters=3, warmup=1)
                plain_bwd_ms = cuda_ms(lambda: A.flash_backward_plain(q, k, v, mask, o, lse, do, scale), iters=3, warmup=1)
                attn_mask = None if mask is None else mask[:, None, None, :]
                lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), iters=iters)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

            def library_fwd_bwd():
                return torch.autograd.grad(F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask), leaves, do)

            lib_fwd_bwd_ms = cuda_ms(library_fwd_bwd, iters=iters)
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask)
            lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), iters=iters)
            del lib_out, leaves
            pairs = float(h * nq * (b * nk if mask is None else int(mask.sum().item())))  # masked keys take no product
            es = q.element_size()
            b_fwd = bound(es * (2 * q.numel() + 2 * k.numel()), 4.0 * pairs * d, dt)
            b_lse = bound(es * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel(), 4.0 * pairs * d, dt)
            b_dq = bound(es * (3 * q.numel() + 2 * k.numel()) + 8 * lse.numel(), 6.0 * pairs * d, dt)
            b_dkv = bound(es * (2 * q.numel() + 4 * k.numel()) + 8 * lse.numel(), 8.0 * pairs * d, dt)
            b_both = bound(es * (4 * q.numel() + 4 * k.numel()), 10.0 * pairs * d, dt)
            bnd = BACKWARD_BOUNDS[dt]
            common = dict(name=name, dtype=dt, shape=[b, h, nq, nk, d], masked=mask is not None, bound=bnd)
            fwd_records.append(dict(common, max_abs_err=o_err, max_rel_err=o_rel, lse_max_abs_err=lse_err,
                                    lse_bound=LSE_BOUNDS[dt], ms=ms_fwd, ms_with_lse=ms_lse, plain_ms=plain_fwd_ms,
                                    library_ms=lib_fwd_ms, bound_ms=b_fwd[0], bound_by=b_fwd[1],
                                    bound_with_lse_ms=b_lse[0], tflops=4.0 * pairs * d / ms_fwd / 1e9))
            back = dict(common, bitwise_repeat=same, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
                        library_forward_backward_ms=lib_fwd_bwd_ms, together_ms=ms_both, together_bound_ms=b_both[0])
            dq_records.append(dict(back, max_abs_err=abs_err["dq"], max_rel_err=rel["dq"], ms=ms_dq, bound_ms=b_dq[0],
                                   bound_by=b_dq[1]))
            dkv_records.append(dict(back, max_abs_err=max(abs_err["dk"], abs_err["dv"]),
                                    max_rel_err=max(rel["dk"], rel["dv"]), ms=ms_dkv, bound_ms=b_dkv[0],
                                    bound_by=b_dkv[1]))
            print(f"[d64] {name:18s} {dt:4s} B,H,Nq,Nk={b},{h},{nq},{nk} mask={mask is not None!s:5s} "
                  f"out rel_err={o_rel:.2e} lse={lse_err:.2e} dq={rel['dq']:.2e} dk={rel['dk']:.2e} dv={rel['dv']:.2e} "
                  f"(bounds {bnd:.0e} of each output's largest magnitude, lse {LSE_BOUNDS[dt]:.0e}) same bits "
                  f"twice={same and same_out} | ms fwd={ms_fwd:.4f} with_lse={ms_lse:.4f} (bound {b_fwd[0]:.4f}, "
                  f"{b_fwd[1]}) dq={ms_dq:.4f} dkv={ms_dkv:.4f} dq+dkv+di={ms_both:.4f} (bound {b_both[0]:.4f}) | "
                  f"plain fwd={plain_fwd_ms:.4f} bwd={plain_bwd_ms:.4f} | torch sdpa fwd={lib_fwd_ms:.4f} "
                  f"bwd={lib_bwd_ms:.4f} fwd+bwd={lib_fwd_bwd_ms:.4f}", flush=True)
            if not (o_rel <= bnd and max(rel.values()) <= bnd and lse_err <= LSE_BOUNDS[dt]):
                fail(f"head dim 64 {name} {dt}: output {o_rel}, lse {lse_err}, gradients {rel} over the bounds")
            if not (same and same_out):
                fail(f"head dim 64 {name} {dt}: two runs on the same inputs differ")
            if dt == "bf16":
                held.add((b, h, nq, nk, d, mask is not None))
            del q, k, v, do, o, lse, ref, got, want, di
    return fwd_records, dq_records, dkv_records, held


# One f32 cldm step with the UNet and the ControlNet cut in depth and width
# but at head dim 64 (the kernels' instantiation), the VAE and SwinIR at full
# width, card against CPU: the loss relative to itself, every gradient against
# the largest gradient magnitude; convolutions, matmuls, GroupNorm and the
# attention kernels sum in other orders than the CPU.
CLDM_F32_BOUND = 1e-3
CLDM_SMALL_NET = dict(model_channels=64, num_res_blocks=1, attention_ds=[1, 2], channel_mult=[1, 2],
                      num_head_channels=64, context_dim=64)


def cldm_phase(held64):
    """The trainer with ``--task cldm`` through its entry point at the full
    ``configs/cldm.yaml`` width (SD-2.1 UNet and ControlNet, the frozen SwinIR
    and VAE) in bf16 from f32 masters, batch 2 at 512x512: 3 steps, then 1
    more from the checkpoint. Every kernel's launches per step are held to
    what the configuration implies (K1 by head dim and log-sum-exp from its
    shape tally, K6 as the draws imply), and every head-dim-64 shape met to
    one ``d64_phase`` held. The frozen UNet's parameters keep their bits, the
    trained ones move. One ``train_step`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the step waits for the card
    nowhere (the loop's one-step-late metric fetch is outside it). Then timed
    steps, one ``--task reflow`` step, and one depth-cut f32 step on the card
    against the CPU. Returns (launches of the 3-step run, launches per step,
    the timing record, K1/K2 launches by head dim)."""
    import gc

    import numpy as np
    import torch

    from instarevive_tpu_torch.config import load_config, merge
    from instarevive_tpu_torch.models.unet import UNetBackbone, zero_init_
    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.pipelines.build import init_params
    from instarevive_tpu_torch.tools import time_train as T
    from instarevive_tpu_torch.train import launcher
    from instarevive_tpu_torch.train.cldm import ControlLDM

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def finite(run, what, keys=("loss", "grads_finite")):
        for i, m in enumerate(run.history):
            if set(m) != set(keys) or not np.isfinite(m["loss"]) or m["grads_finite"] != 1.0:
                fail(f"{what}: metrics of step {run.start_step + i} are {m}")

    config = os.path.join(REPO, "configs", "cldm.yaml")
    cfg = load_config(config)
    attn = T.cldm_attention_counts(cfg)
    per_step = dict(dict.fromkeys(counters(), 0), **T.cldm_expected_launches(cfg))
    trained = ("controlnet.", "unet.output_blocks.", "unet.out.")

    # the frozen UNet as the launcher initialises it (its default seed): what every frozen weight must stay
    with torch.device("cuda"):
        fresh = ControlLDM(UNetBackbone(**cfg["unet"]), UNetBackbone(**cfg["controlnet"]))
    init_params(fresh, seed=0)
    zero_init_(fresh.unet), zero_init_(fresh.controlnet)
    # kept on the host, so that the run's peak device memory is the trainer's own
    frozen_init = {n: p.detach().cpu() for n, p in fresh.named_parameters() if not n.startswith(trained)}
    trained_init = {n: p.detach().cpu() for n, p in fresh.named_parameters() if n.startswith(trained)}
    del fresh
    free()

    with tempfile.TemporaryDirectory() as tmp:
        data = T.write_images(os.path.join(tmp, "hq"))
        out = os.path.join(tmp, "run")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        A.flash_attention.shapes, A.flash_dq.shapes, A.flash_dkv.shapes = {}, {}, {}
        try:
            t0 = time.perf_counter()
            run = launcher.main(T.train_argv(config, data, out, 3, task="cldm"))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            tallies = (A.flash_attention.shapes, A.flash_dq.shapes, A.flash_dkv.shapes)
        finally:
            A.flash_attention.shapes = A.flash_dq.shapes = A.flash_dkv.shapes = None
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite(run, "train cldm")
        task = run.task
        want = dict({k: 3 * v for k, v in per_step.items()}, filter2d=task.degrade.filter_calls)
        if (run.start_step, run.end_step, len(run.history)) != (0, 3, 3) or counts != want \
                or not 6 <= counts["filter2d"] <= 9:
            fail(f"train cldm: ran steps {run.start_step}..{run.end_step}; kernel launches {counts}, the configuration "
                 f"and the draws imply {want}")
        fwd_shapes, dq_shapes, dkv_shapes = tallies
        by_dim = {"d64": sum(n for key, n in fwd_shapes.items() if key[4] == 64),
                  "d64_with_lse": sum(n for key, n in fwd_shapes.items() if key[4] == 64 and key[6]),
                  "d512": sum(n for key, n in fwd_shapes.items() if key[4] == 512),
                  "flash_attn_bwd_dq": sum(dq_shapes.values()), "flash_attn_bwd_dkv": sum(dkv_shapes.values())}
        want_dim = {k: 3 * attn[k] for k in by_dim}
        if by_dim != want_dim:
            fail(f"train cldm: attention launches by head dim {by_dim}, the configuration implies {want_dim}")
        met = {key[:6] for key in fwd_shapes if key[4] == 64} | set(dq_shapes) | set(dkv_shapes)
        if met - held64:
            fail(f"train cldm: head-dim-64 shapes the kernel phase did not hold: {sorted(met - held64)}")
        (state, lsm) = task.states
        params = {n: p.detach().cpu() for n, p in task.model.named_parameters()}
        if sorted(state.names) != sorted(n for n in params if n.startswith(trained)) or lsm is not None:
            fail("train cldm: the optimizer does not hold exactly the ControlNet and the UNet's decoder")
        if not all(torch.equal(params[n], p) for n, p in frozen_init.items()):
            fail("train cldm: a frozen parameter moved")
        moved = sum(not torch.equal(params[n], p) for n, p in trained_init.items())
        if torch.equal(params["unet.out.2.weight"], trained_init["unet.out.2.weight"]) or moved < 5:
            fail(f"train cldm: of {len(trained_init)} trained tensors {moved} moved")
        print(f"[train cldm] {card_line()}: configs/cldm.yaml at full width (UNet {sum(p.numel() for n, p in params.items() if n.startswith('unet.')) / 1e6:.1f} M, "
              f"ControlNet {sum(p.numel() for n, p in params.items() if n.startswith('controlnet.')) / 1e6:.1f} M parameters, "
              f"{sum(p.numel() for p in state.params) / 1e6:.1f} M trained), bf16 compute from f32 masters, batch "
              f"{T.BATCH} at {T.CROP}x{T.CROP}: 3 steps through train.launcher.main in {seconds:.1f}s (set-up, first-use "
              f"builds and the checkpoint included); launches per step {({k: v for k, v in per_step.items() if v})} as "
              f"the configuration implies, filter2d {counts['filter2d']} in the 3 degradations as their draws imply; "
              f"K1 by head dim over 3 steps {by_dim}; head-dim-64 shapes met (B, H, Nq, Nk, D, masked, lse) "
              f"{sorted(fwd_shapes.items())}; losses {[round(m['loss'], 6) for m in run.history]}; {len(frozen_init)} "
              f"frozen tensors as initialised, {moved} of {len(trained_init)} trained ones moved; peak allocated "
              f"{peak:.2f} GiB", flush=True)
        del run, task, state, params
        free()

        reset_counts()
        again = launcher.main(T.train_argv(config, data, out, 4, ["--resume", os.path.join(out, "final")], task="cldm"))
        finite(again, "train cldm, resumed")
        if (again.start_step, again.end_step, len(again.history)) != (3, 4, 1) \
                or read_counts() != dict(per_step, filter2d=again.task.degrade.filter_calls) \
                or again.task.states[0].step != 4 or again.task.states[0].opt_state["inner"]["count"] != 4:
            fail(f"train cldm, resumed: ran steps {again.start_step}..{again.end_step}, launches {read_counts()}")
        print(f"[train cldm] resumed from 'final' at step 3, took 1 step with the same launches: {again.history[-1]}",
              flush=True)

        task = again.task
        batch = T.load_batches(data, 1)[0]
        pair = task.degrade(torch.from_numpy(batch["hq"]).to("cuda").float() / 255.0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            task.train_step(pair)
        except RuntimeError:
            import traceback

            fail(f"train cldm: train_step synchronised with the card:\n{traceback.format_exc()}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print("[train cldm] one train_step under torch.cuda.set_sync_debug_mode('error'): no synchronising call "
              "(nan_guard keeps its flag on the card)", flush=True)

        timing = T.time_steps(task, T.load_batches(data, 5), T.CLDM_PHASES)
        want_attn = {k: attn[k] for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
        if timing["launches_per_step"] != want_attn:
            fail(f"train cldm: timed steps launched {timing['launches_per_step']}, expected {want_attn}")
        print(f"[train cldm] warm s/step {timing['step_median_s']:.4f} (steps {', '.join(f'{t:.4f}' for t in timing['step_s'])}); "
              "split, median ms by CUDA events: " + ", ".join(f"{k} {v:.1f}" for k, v in timing["phase_median_ms"].items())
              + f"; peak allocated {timing['peak_allocated_gib']:.2f} GiB", flush=True)
        del again, task, pair
        free()

        # one reflow step at full width, through the same task class the launcher builds for --task reflow
        args = launcher.parse_args(T.train_argv(config, data, os.path.join(tmp, "reflow"), 1, task="reflow"))
        refl = launcher.CLDMTask(args, cfg, torch.device("cuda"))
        reset_counts()
        m = {k: float(v) for k, v in refl.run_step(batch).items()}
        torch.cuda.synchronize()
        got = {k: v for k, v in read_counts().items() if k != "filter2d"}
        if set(m) != {"loss", "reflow_mse", "grads_finite"} or not np.isfinite(m["loss"]) \
                or got != {k: v for k, v in per_step.items() if k != "filter2d"}:
            fail(f"train reflow: metrics {m}, launches {got}")
        print(f"[train reflow] one step at full width: {m}, launches as for cldm", flush=True)
        del refl
        free()

        err = cldm_step_card_against_cpu(cfg, merge)
    return counts, per_step, dict(timing, three_steps_s=seconds, peak_allocated_first_run_gib=peak, card_vs_cpu=err,
                                  attention_by_head_dim_3_steps=by_dim), by_dim


def cldm_step_card_against_cpu(cfg_full, merge):
    """One f32 ``CLDMTask.train_step`` with the UNet and the ControlNet cut
    to CLDM_SMALL_NET (head dim 64) and every layer random (no zero init, so
    every gradient is exercised), the VAE and SwinIR at full width, on the
    card and on the CPU: the same weights, pair and draws."""
    import torch

    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.pipelines.build import init_params
    from instarevive_tpu_torch.tools import time_train as T
    from instarevive_tpu_torch.train import launcher

    cfg = merge(cfg_full, {"unet": CLDM_SMALL_NET, "controlnet": CLDM_SMALL_NET})
    args = launcher.parse_args([a for a in T.train_argv("-", "-", "-", 1, task="cldm") if a != "--bf16"])
    cpu, gpu = launcher.CLDMTask(args, cfg, torch.device("cpu")), launcher.CLDMTask(args, cfg, torch.device("cuda"))
    init_params(cpu.model, seed=3)
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.pipe.load_state_dict(cpu.pipe.state_dict())
    gen = torch.Generator().manual_seed(5)
    pair = {"hq": torch.rand(T.BATCH, 128, 128, 3, generator=gen) * 2 - 1, "lq": torch.rand(T.BATCH, 128, 128, 3, generator=gen)}
    draws = {"t": torch.tensor([17, 803]), "noise": torch.randn(T.BATCH, 16, 16, 4, generator=gen)}
    res = {}
    for label, task in (("cpu", cpu), ("cuda", gpu)):
        kept = []
        reset_counts()
        metrics = task.train_step({k: v.to(task.device) for k, v in pair.items()}, keep_grads=kept,
                                  draws={k: v.to(task.device) for k, v in draws.items()})
        res[label] = (float(metrics["loss"]), [g.cpu() for g in kept])
    counts = read_counts()
    want = T.cldm_attention_counts(cfg)
    if (counts["flash_attn_fwd"], counts["flash_attn_bwd_dq"], counts["flash_attn_bwd_dkv"]) != \
            (want["flash_attn_fwd"], want["flash_attn_bwd_dq"], want["flash_attn_bwd_dkv"]):
        fail(f"cldm step, card against CPU: attention launches {counts}, expected {want}")
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res["cuda"]
    top = max(g.abs().max().item() for g in g_cpu)
    errs = {"loss": abs(l_gpu - l_cpu) / l_cpu, "grad": max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu)) / top}
    print(f"[train cldm] one f32 step, UNet and ControlNet at {CLDM_SMALL_NET} (head dim 64), VAE and SwinIR at full "
          f"width, every layer random, card against CPU (same weights, pair and draws): loss on the CPU {l_cpu:.6f}; "
          f"relative differences " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {CLDM_F32_BOUND:.0e}); attention launches on the card {want}", flush=True)
    if not max(errs.values()) <= CLDM_F32_BOUND:
        fail(f"cldm step: the card differs from the CPU by {errs}")
    return errs


def d64_entries(fwd_records, dq_records, dkv_records, by_dim):
    """The head-dim-64 instantiations' entries of the ``kernels`` line: the
    UNet's largest self-attention (ds 1) at top level, every shape below;
    ``launches`` is the 3-step ``--task cldm`` run's count from the shape
    tally."""
    out = []
    for name, replaces, records, launches in (
            ("flash_attn_fwd_d64", "instarevive_tpu/ops/attention.py:63", fwd_records, by_dim["d64"]),
            ("flash_attn_bwd_dq_d64", "instarevive_tpu/ops/attention.py:127", dq_records, by_dim["flash_attn_bwd_dq"]),
            ("flash_attn_bwd_dkv_d64", "instarevive_tpu/ops/attention.py:166", dkv_records, by_dim["flash_attn_bwd_dkv"])):
        main_rec = next(r for r in records if r["name"] == "ds1_self" and r["dtype"] == "bf16")
        bf16 = [r for r in records if r["dtype"] == "bf16"]
        entry = {"name": name, "route": "cuda",
                 "source": "instarevive_tpu_torch/csrc/" + ("flash_attn_fwd.cu" if "fwd" in name else "flash_attn_bwd.cu"),
                 "replaces": replaces, "launches": launches, "launches_cldm_run": launches,
                 "max_abs_err": max(r["max_abs_err"] for r in bf16), "max_rel_err": max(r["max_rel_err"] for r in bf16),
                 "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
                 "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
                 "main_shape": main_rec["shape"], "shapes": records}
        if name == "flash_attn_fwd_d64":
            entry["launches_with_lse_cldm_run"] = by_dim["d64_with_lse"]
        out.append(entry)
    return out


def filter_entry(records, swinir_counts, dmd_counts, degrade_launches):
    """K6's entry of the ``kernels`` line: f32, the stage-1 blur's times at
    top level; ``launches`` is the count of the 3-step ``--task swinir`` run."""
    main_rec = next(r for r in records if r["name"] == "realesrgan_hq_b2_512")
    return {
        "name": "filter2d", "route": "cuda", "source": "instarevive_tpu_torch/csrc/filter2d.cu",
        "replaces": "instarevive_tpu/ops/filters.py:106", "launches": swinir_counts["filter2d"], "launches_tiled": 0,
        "launches_swinir_train_run": swinir_counts["filter2d"], "launches_train_run": dmd_counts["filter2d"],
        "launches_degrade": degrade_launches, "max_abs_err": max(r["max_abs_err"] for r in records),
        "max_rel_err": max(r["max_rel_err"] for r in records),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
        "library": "reflect F.pad + one grouped F.conv2d: the plain version itself", "main_shape": main_rec["shape"],
        "shapes": records,
    }


def kernel_entry(name, source, replaces, launches, tiled_launches, records, main_name, train=None):
    """One entry of the ``kernels`` line: the main-path shape's times at top
    level, the largest bf16 error over all shapes, every shape below.
    ``launches`` is the count of the ``process`` run, or, for a kernel that
    only training launches, of the 3-step training run; ``train`` is (that
    run's counts, the counts of one step)."""
    main_rec = next(r for r in records if r["name"] == main_name and r["dtype"] == "bf16")
    bf16 = [r for r in records if r["dtype"] == "bf16"]
    entry = {
        "name": name, "route": "cuda", "source": f"instarevive_tpu_torch/csrc/{source}", "replaces": replaces,
        "launches": launches[name], "launches_tiled": tiled_launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in bf16),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
        "main_shape": main_rec["shape"], "shapes": records,
    }
    if train is not None:
        entry["launches_train_run"], entry["launches_train_step"] = train[0][name], train[1][name]
        if name in BACKWARD_KERNELS:
            entry["launches"] = train[0][name]
    if "max_rel_err" in main_rec:  # the fold and the attention backward are held to a relative bound
        entry["max_rel_err"] = max(r["max_rel_err"] for r in bf16)
    # the fused convolution's ms covers its moments launches; the window attention has a second yardstick
    for key in ("includes", "conv_only_ms", "library_composition_ms", "max_abs_err_vs_f32"):
        if key in main_rec:
            entry[key] = main_rec[key]
    return entry


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, REPO)
    from instarevive_tpu_torch.config import load_config
    from instarevive_tpu_torch.ops import cuda_build
    from instarevive_tpu_torch.pipelines.build import set_precision

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    set_precision()  # no TF32: the plain versions' f32 convolutions are f32

    fwd_build = None
    for name, (seconds, cached, log) in cuda_build.build_libraries().items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
        print(f"[build] {', '.join(cuda_build.LIBRARIES[name])} for sm_90a: {seconds:.1f}s"
              + (" (cached build)" if cached else f" (nvcc runs together; registers {regs}, spill stores {spills} B)"),
              flush=True)
        if name == "flash_attn_fwd":
            fwd_build = hopper_build_report(log)

    attn_records = kernel_phase()
    dq_records, dkv_records, lse_records = backward_phase()
    d64_fwd, d64_dq, d64_dkv, held64 = d64_phase()
    conv_records = conv_phase()
    stats_records, apply_records, up_records = norm_phase()
    swin_records = swin_phase()
    from instarevive_tpu_torch.tools import time_degrade

    filter_records = time_degrade.hold_filter2d(fail=fail)
    cfg = load_config(os.path.join(REPO, "configs", "instarevive_v1.yaml"))
    small_pipeline_phase(cfg)
    launches, tiled = pipeline_phase(conv_records, swin_records)
    cli_phase()
    serve_phase(cfg, swin_records, launches)
    train = train_phase(cfg)
    timing = train[2]
    degrade_launches, degrade_timing = degrade_phase(filter_records)
    swinir_train = swinir_train_phase(cfg, swin_records, filter_records)
    cldm = cldm_phase(held64)

    fwd = kernel_entry("flash_attn_fwd", "flash_attn_fwd.cu", "instarevive_tpu/ops/attention.py:63",
                       launches, tiled, attn_records, "dit_self", train)
    fwd["with_lse"] = lse_records  # the training forward: the same kernel writing the row log-sum-exp
    fwd["build"] = fwd_build
    swin = kernel_entry("swin_window_attention", "swin_attention.cu", "instarevive_tpu/ops/swin_attention.py:48",
                        launches, tiled, swin_records, "process_b4_64x64_shifted", train)
    up = kernel_entry("upsample2x", "norm_kernels.cu", "instarevive_tpu/ops/norm_kernels.py:143",
                      launches, tiled, up_records, "b4_256_256", train)
    for entry in (swin, up):  # forward launches of the SwinIR trainer; their backward is the plain version's
        entry["launches_swinir_train_run"] = swinir_train[0][entry["name"]]
        entry["launches_swinir_train_step"] = swinir_train[1][entry["name"]]
    print(json.dumps({"kernels": [
        fwd,
        kernel_entry("flash_attn_bwd_dq", "flash_attn_bwd.cu", "instarevive_tpu/ops/attention.py:127",
                     launches, tiled, dq_records, "dit_self", train),
        kernel_entry("flash_attn_bwd_dkv", "flash_attn_bwd.cu", "instarevive_tpu/ops/attention.py:166",
                     launches, tiled, dkv_records, "dit_self", train),
        kernel_entry("gn_silu_conv3x3", "gn_conv.cu", "instarevive_tpu/ops/gn_conv.py:112",
                     launches, tiled, conv_records, "b4_512_128_128", train),
        kernel_entry("gn_stats_fold", "norm_kernels.cu", "instarevive_tpu/ops/norm_kernels.py:77",
                     launches, tiled, stats_records, "b4_512_128", train),
        kernel_entry("gn_apply", "norm_kernels.cu", "instarevive_tpu/ops/norm_kernels.py:86",
                     launches, tiled, apply_records, "b4_512_128", train),
        up,
        swin,
        filter_entry(filter_records, swinir_train[0], train[0], degrade_launches),
        *d64_entries(d64_fwd, d64_dq, d64_dkv, cldm[3]),
    ], "train": timing, "train_swinir": swinir_train[2], "train_cldm": cldm[2], "degrade": degrade_timing}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
