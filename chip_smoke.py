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
   for the forward (bf16 at head dims 64, 72 and 512; f32 at 32, 64, 72 and
   512 on split-tf32 products), the backward (both passes at head dims 64 and
   72, bf16 and f32, and f32 at 32 and 512) and the fused convolution (bf16, and f32 on split-tf32
   products) also their shared memory a block, blocks an SM and their count
   of wgmma (HGMMA) and TMA-load (UTMALDG) instructions (the f32 convolution's
   FFMA too), and fails if either count is 0 (for the head-dim-512 kernel,
   the f32 forms and their head-dim-32 instantiations too), if the forward library or the backward's or the
   convolution's kernels hold an mma.sync (HMMA), or if the head-dim-512
   kernel, a backward kernel or an f32 form spills; for the window attention
   (bf16, and f32 on split-tf32 products) its registers, the heads an item,
   shared memory, ring slots and blocks an SM at ``process``'s shape, and its
   mma.sync (HMMA), ldmatrix (LDSM) and cp.async (LDGSTS) counts, failing on
   a spill or a count of 0; for the 2-D filter every instantiation's
   registers and spills (one a band width and rows a thread), the shared
   memory and blocks an SM of the degradation shapes' plans, and the FFMA,
   LDS and LDGSTS counts of the main path's instantiation, failing on a spill
   or a count of 0;
3. holds every kernel against its plain PyTorch version at the shapes the
   main path gives it, with a stated bound, and times the kernel, the plain
   version and, as a yardstick only, the one library call or composition for
   the same function: flash attention (K1, with ragged and masked shapes
   and its TFLOP/s; the 2K sampling call's shapes at 16,384 queries over
   16,384, 4,096 and 300 keys and its decode's (2, 1, 65536, 65536, 512),
   whose plain version runs in query chunks; head dim 512 at the VAE mid block's three shapes: process,
   the tiled call's encode and its tile's decode, and in f32 at the DMD step's
   encode and a ragged masked shape, where ``sdpa`` with TF32 matmuls is shown
   outside the f32 bound), the split prepass of the f32 attention
   (``tf32_planes``, bit for bit against ``tf32_planes_plain``, head dims 64,
   72 and 512), the fused GN+SiLU+conv3x3 (K3, bf16 at the restoration
   path's shapes and at the 2048x2048 decode's (2^31-element tensors), and
   f32, on split-tf32 products, at every shape an f32 run
   here launches and the f32 DMD step's encode; ragged shapes, a bitwise
   repeat, cuDNN's convolution alone on the activated input beside the
   kernel alone, a border case in both types that tells a zero halo from a
   ``silu(b)`` halo, and all five gradients against autograd through the
   plain version), the
   GroupNorm moments and fold (K5a), the GroupNorm apply (K5b), the
   nearest 2x upsample (K5c) (all three also at the 2048x2048 decode's
   shapes), the Swin window attention (K4, bf16 and f32 on
   split-tf32 products, shifted, unshifted and at odd shifts, a bitwise
   repeat; each form's registers, shared memory, blocks an SM and SASS counts
   in the build report) and the per-sample reflect-padded 2-D filter (K6,
   f32, at the shapes of both degradation programs, ragged shapes, a shared
   kernel, the card tests' hard shapes: 1, 2, 5, 6, 64 and 128 channels,
   reflect at its limit; one launch a call at every C, the same bits twice,
   and a border case that tells reflect from edge repeat);
4. runs a small full-width pipeline (depth cut) in f32 on the card and on
   the CPU, and holds the two against each other; the f32 runs here (this
   one, the depth-cut f32 server of 7, the f32 train steps of 8 and 12) tally
   K3's launches by shape and fail on an f32 shape 3 did not hold;
5. builds the full-width ``configs/instarevive_v1.yaml`` pipeline in bf16
   with seeded random weights, runs ``process`` on a 4x512x512 batch and
   ``process_tiled`` on a 1024x1024 image, checks the outputs and that every
   kernel was launched exactly as often as the configuration says (K1 at
   head dim 512 by shape, each shape one held in 3), and
   prints seconds, MP/s and peak memory;
6. runs the CLI (``python -m instarevive_tpu_torch.inference``) on two PNGs,
   whose restorations 16 scores;
7. starts the port's server (``instarevive_tpu_torch.serve``) in this process
   at full width in bf16, sends it concurrent ``POST /restore`` requests in
   two shape buckets, checks every answer and ``/healthz``, runs the demo's
   restorer (``instarevive_tpu_torch.interface``) on one image, and holds one
   answer of a depth-cut f32 server against ``process`` called directly;
8. runs the trainer (``instarevive_tpu_torch.train``) at full width in bf16
   from f32 master weights on 8 PNGs it writes from a seed: 3 steps of DMD
   distillation, then 1 more from the checkpoint, with the launches of K1 and
   K2 per step held to what the configuration implies; times warm steps;
   takes a step under ``--remat_policy dots`` (launches per step as under
   ``full``, warm steps and peak memory beside ``full``'s, and one step from
   the same seed and batch bit for bit ``full``'s parameters);
   runs ``--lowmem`` at depth 2; and holds one depth-2 f32 train step on the
   card against the CPU, counting its f32 attention and prepass launches;
9. runs both degradation programs (``data/realesrgan.degrade_batch``,
   ``data/codeformer.degrade_batch_codeformer``) on a seeded (2, 512, 512, 3)
   batch on the card: outputs checked, K6's launches held to what the draws
   imply and its shapes to those held in 3, the same seed twice, the card
   against the CPU under one set of handed-in draws, wall and split per call;
10. runs the trainer with ``--task swinir`` at the full v1 SwinIR width in
   bf16 from f32 masters, batch 2 at 512x512: 3 steps, then 1 more from the
   checkpoint under ``--trace_steps 1 --trace_at 3`` (the torch trace 16
   reads), K4, K5c and K6 launches per step held; times warm steps; and
   holds one depth-cut f32 step on the card against the CPU;
11. holds the flash-attention kernels at head dim 64 (K1 with and without the
   log-sum-exp, K2's dq and dk/dv) against their plain versions at every
   UNet and ControlNet shape of ``configs/cldm.yaml``, bf16 and f32, timed
   against ``F.scaled_dot_product_attention`` forward and backward, and the
   same at head dim 32 in f32 at the toy training-validation tool's shapes
   (``time_flash_bwd.D32_CASES``, which 19 reads; these run with the other kernel phases,
   after 3);
12. runs the trainer with ``--task cldm`` at the full ``configs/cldm.yaml``
   width (SD-2.1 UNet, ControlNet, the frozen SwinIR and VAE) in bf16 from f32
   masters, batch 2 at 512x512: 3 steps, then 1 more from the checkpoint,
   every kernel's launches per step held (K1 by head dim), every head-dim-64
   shape held in 11, frozen weights unchanged, one ``train_step`` under
   ``torch.cuda.set_sync_debug_mode("error")``; times warm steps; takes one
   ``--task reflow`` step; and holds one depth-cut f32 step at head dim 64 on
   the card against the CPU, counting its f32 attention and prepass launches;
13. runs the sampling CLI's function (``instarevive_tpu_torch.sample``) at
   full v1 width in bf16 with seeded random weights: two prompts (the null
   embedding, guidance 4.5) at 512x512, 20 steps of DPM-Solver++(2M), DDIM,
   SA-Solver and DDPM (respaced to 20); images checked, every kernel's
   launches held to 20 DiT calls and a decode, every K1 (head dims 72 and
   512) and K3 shape one held in 3; wall a call, ms a step, peak memory;
   one call of each under ``torch.cuda.set_sync_debug_mode("error")``;
   then a depth-cut f32 copy (DiT depth 2, 4 DPM-Solver steps) on the card
   against the CPU;
14. runs the validation function (``instarevive_tpu_torch.validate``) on two
   seeded 512x512 PNGs with 13 ControlNet-Half stages and 20 steps: degrade
   on the card, SwinIR, encode, sample, decode, PSNR and SSIM finite; K1
   20 x 2 x (28 + 13) + 2, K4 48, K6 as the draws say, every K1, K3, K4 and K6
   shape held; wall and peak memory; then a depth-cut f32 control step on the
   card against the CPU;
15. runs the sampling CLI's functions at ``--config configs/pixart_kv2k.yaml
   --image_size 2048`` (the pipeline as ``inference.load_pipeline`` builds
   it, bf16, seeded random weights): two prompts, SAMPLE_2K_STEPS (10) steps of
   DPM-Solver++(2M) with the DiT at batch 4 on a 128 x 128 token grid (blocks
   0-13 over K and V compressed 2x a side by the depthwise conv), the decode
   at 2048x2048; images checked, every kernel's launches held, K1's by shape
   (10 x 2 x 28 + 1 = 561: 140 at 16,384 keys, 140 at 4,096, 280 over the
   caption, 1 at head dim 512), every K1 and K3 shape one held in 3; wall a
   call, ms a step, peak memory; then a depth-cut full-width f32 DiT with
   every option on (``conv``, ``uniform`` and ``ave`` compression, qk-norm, a
   window over a grid it does not divide, micro-conditioning with and without
   ``data_info``) on the card against the CPU;
16. evaluates images (``instarevive_tpu_torch.evaluate_img``): LPIPS
   (AlexNet), MUSIQ, MANIQA, CLIP RN50 (with a stub tokenizer, no file read)
   and RetinaFace built at their published widths from
   seeded official-layout state dicts through the port's loaders; 6's
   restorations scored against their inputs (PSNR, SSIM, LPIPS, NIQE on the
   host, MUSIQ, MANIQA, CLIP-IQA), every value finite and in its range, no
   kernel of the port launched, wall per image per metric, peak memory; each
   network in f32 on the card against the CPU on one image (1e-5 of
   max|CPU|); one RetinaFace detection and one align -> paste round trip on a
   512x512 image; one forward of the full-width v1 SwinIR with the residual
   head (``upsampler: ""``, no unshuffle) on 4x512x512 in bf16, K4 48 times
   at the shapes 3 held (``residual_b4_512x512``) and K5c not at all; and
   10's trace, which must name K4's ``swin16::kernel``;
17. runs the text encoders, the data-preparation CLIs, RRDBNet, depth and the
   captioner at the published widths of their configurations, each built on
   the card in f32 with seeded weights (``aux_phase``): T5 v1.1 XXL's encoder
   on two prompts at 300 tokens, then a prompted 20-step DPM-Solver++(2M)
   sample at 512x512 (guidance 4.5, every kernel's launches held, images
   other than the null prompt's); ``tools/extract_features.py`` over 8 seeded
   512x512 PNGs at batch 8 with T5 captions (the f32 VAE encode: K3, K5a/b
   and K1 at head dim 512, every shape held in 3); the OpenCLIP ViT-H/14 text
   tower (penultimate layer); ``tools/lq.py`` on 2 images (K6 at 41 x 41
   taps); RRDBNet x4 (64 features, 23 blocks) tiled over 256x256; DPT-Hybrid
   and DPT-Large at 384x384 (K1 at (2, 12 | 16, 577, 577, 64) in f32, one
   launch a ViT block, held in 3), MiDaS v2.1 at 384 and v2.1-small at 256,
   each ``depth_fn`` into the depth2image conditioning; LLaVA-MPT-7B with a
   CLIP ViT-L/14 tower at 224 decoding 32 greedy tokens. Each prints its wall
   to a synchronise, peak memory and kernel launches, and a depth-cut copy at
   full width in f32 on the card against the CPU (``AUX_CARD_CPU_BOUND``);
18. runs the parallel paths (``parallel_phase``) on the full-width v1
   pipeline (bf16, 4x512x512) through a real NCCL group of one rank:
   ``sharded``, ``tp``, ``sp`` and ``pp`` of ``process``, each bit for bit
   against the one-card call of the same arithmetic (``process``; for pp the
   blocks run on each of the 2 microbatches), K1's shapes held in 3; then 3
   bf16 DMD steps (batch 2 at 512x512) unwrapped, under DDP(1) and under
   FSDP2(1), bit for bit with the same launches, each one's walls and peak
   memory; then two gloo ranks sharing the card, twice in processes of
   their own: the first pair probes which collectives gloo takes on CUDA
   tensors (a refused one may end its process), the second runs each mode
   whose collectives were all taken, at full width against the one-rank
   output; only a refused probe makes a mode print as refused, any other
   failure on either rank fails the phase (sharded and pp bit for bit against
   the same arithmetic, tp and sp within ``PARALLEL_TWO_RANK_BOUND``), with
   K1 at the new shapes (``tp2_*``, ``sp2_*``) held in 3; their walls go
   through host memory and measure no speed;
19. runs the training-validation tools (``trainval_phase``): the toy tool's
   ``main`` (``tools/train_validation.py``) whole at its defaults on the card
   in f32, every JAX assert holding (the teacher trains, the DMD EMA beats
   its init, Reflow trains and its EMA beats its init), K1 and K2 at head
   dim 32 only and at shapes the head-dim-32 phase held (``time_flash_bwd.D32_CASES``: K1
   with and without the log-sum-exp, K2's dq and dk/dv, f32, and the
   prepass there bit for bit), each stage's launches held to its steps;
   then the production tool's stage functions at full XL-2 width in bf16
   under ``dots`` (``TRAINVAL_PROD_ARGV``: a cut teacher at which its assert
   holds, 2 pair batches, a few DMD steps, 4 held noises through the bf16
   decode and NIQE at block 96), every figure finite, every K1, K2, K3 and
   K5 shape one the kernel phases held (K2 at batch 4 in
   ``TRAINVAL_BACKWARD_CASES``, K5 at a 512x512 decode at batch 2); then one
   teacher step and two DMD steps of that tool at depth 2, full width, f32,
   card against CPU (TRAIN_F32_BOUND). Each prints walls, steps/s or s a
   step, launches and peak memory;
20. runs a gradient through the frozen f32 VAE (``vae_grad_phase``), the
   path of the Reflow trainer's LPIPS term (``distill.reflow_loss`` with
   ``lpips_fn(z, hq) = LPIPS(decode(z / 0.18215), hq).mean()``): (a) K2's f32
   form at head dim 512 (dq; dk/dv) against ``flash_backward_plain`` at the
   full run's decode (2, 1, 4096, 4096, 512), the cut run's (2, 1, 1024,
   1024, 512) and a ragged shape with a sample whose keys are all masked
   (BACKWARD_BOUNDS, the same bits twice), K1's f32 form there without and
   with its log-sum-exp against ``sdpa`` and ``flash_lse_plain``, each timed
   alone beside the prepass, the plain versions and
   ``F.scaled_dot_product_attention``'s f32 backward (TF32 off), and K5's
   input gradient (kernels forward, the plain composition backward) at the
   decode's AttnBlock.norm and norm_out shapes; (b) ``configs/cldm.yaml`` at
   full width in f32, batch 2 at 512x512: two Reflow steps with the LPIPS
   term through the trainer's own task, backward to the ControlNet and the
   UNet's decoder, then the optimizer; every loss, metric and gradient norm
   finite, every kernel's launches as the configuration implies (K1 at head
   dim 512 with its log-sum-exp and K2's dq and dk/dv there once a step,
   beside the two encodes' K1), every shape held in 3, 11 or (a); walls and
   peak memory; (c) the same step cut (UNet and ControlNet at
   CLDM_SMALL_NET, the VAE with one res block a level, mid width 512) at
   256x256 on the card and on the CPU, the same weights, pair and draws,
   within CLDM_F32_BOUND.

Each phase prints its seconds (``[phase]`` lines, and ``phase_s`` in the JSON
line). It then prints one JSON line describing the kernels, the card line
again and, last, ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that last line; without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Bounds for the kernel against sdpa on the same inputs (V in [-1, 1], so
# |out| <= 1). bf16: both outputs are rounded to bf16 (spacing 2^-8 just
# below 1) and the kernel rounds P to bf16 before P.V where sdpa keeps it
# f32, so a few bf16 steps; 1e-2. f32: only the summation order differs
# (online softmax over key tiles against one softmax) and the split-tf32
# products' dropped lo.lo term, about 2^-22 of each product; 1e-4.
BOUNDS = {"bf16": 1e-2, "f32": 1e-4}
# |out| <= 1 is loose where many keys share the weight: at head dim 512 over
# thousands of keys the output is near 0.01 and 1e-2 would pass a kernel that
# dropped a key tile. So each output is also held to a share of its
# reference's largest magnitude. bf16: 2e-2, the bf16 rounding of either
# output is 2^-8 = 3.9e-3 of the largest value, and P's bf16 rounding a few
# such steps more. f32: 1e-4, where products in plain TF32 (10 mantissa
# bits, as ``sdpa`` with ``allow_tf32``) land near 5e-4 of it and the split's
# about 2^-21 of a product keeps a few 1e-6.
REL_BOUNDS = {"bf16": 2e-2, "f32": 1e-4}
# The backward kernels against flash_backward_plain on the same q, k, v, o, lse
# and dO (randn q, k, dO; v in [-1, 1]), per output (dq, dk, dv), relative to
# that output's largest magnitude. bf16: both round P, dS and the output to
# bf16 at the same places; an f32 sum taken in another order can land on the
# other side of a rounding boundary, which moves an output by one bf16 step
# (2^-8 = 3.9e-3 of the largest value) and a P or dS term by as much of
# itself; 1e-2. f32: the order of the sums, ex2 against exp, and the split-tf32
# products' dropped lo.lo term (about 2^-22 of each product); 2e-5.
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
# tensor-core bf16 and TF32 FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES, PEAK_BF16, PEAK_TF32, PEAK_F32 = 3.35e12, 989e12, 495e12, 67e12
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


def bound(nbytes: float, flops: float, dt: str, split: bool = False):
    """(least ms the card could take, which limit sets it): bytes moved once
    over the memory rate, or operations over the peak rate of their type;
    with split (the f32 attention), three tf32 products for each f32 one over
    the TF32 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if split:
        t_ops = 3 * flops / PEAK_TF32 * 1e3
    else:
        t_ops = flops / (PEAK_BF16 if dt == "bf16" else PEAK_F32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_form(dt: str) -> bool:
    """Whether the kernels run split-tf32 products at this type: the f32 forms
    of the attention (every head dim), of the fused conv and of the window
    attention."""
    return dt == "f32"


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
    """K3 against the plain version at every shape of the main path (bf16)
    and of this run's f32 paths (f32, the split-tf32 form) and at shapes
    ragged against its pixel tiles, twice (the bits must repeat); the
    yardstick is group_norm -> silu -> conv2d in channels-last (TF32 off).
    ``ms`` is the wrapper's time, the moments and fold launches inside it
    included (in f32 on the weight's planes made before, as a module caches
    them; ``prepass_ms`` is their prepass); ``conv_only_ms`` is the
    convolution kernel alone on a fold made before, and ``conv_library_ms``
    cuDNN's ``F.conv2d`` alone on the activated input (channels-last, x's
    dtype), the one library call for what the kernel body computes. f32
    bounds count three tf32 products a product at the TF32 rate
    (``bound_fma_ms``: at the f32 FMA rate). ``tile_n`` is the channel tile
    the launcher took. Returns per-shape records."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import cuda_build, gn_conv
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain, weight_planes
    from instarevive_tpu_torch.ops.norm_kernels import affine_silu_plain, gn_affine

    tile_n = cuda_build.load_library("gn_conv").gn_silu_conv3x3_tile_n
    tile_n.argtypes, tile_n.restype = [ctypes.c_int], ctypes.c_int

    b4 = [  # process at 4 x 512 x 512: (H = W, C, Co)
        (512, 128, 128), (256, 128, 256), (256, 256, 256), (128, 256, 512),
        (128, 512, 512), (64, 512, 512), (256, 512, 256), (512, 256, 128),
    ]
    cases = [(f"b4_{hw}_{c}_{co}", (4, hw, hw, c, co), ("bf16",)) for hw, c, co in b4]
    # the same layers at batch 2: a sample call's decode, a validation batch's encode and decode
    cases += [(f"b2_{hw}_{c}_{co}", (2, hw, hw, c, co), ("bf16",)) for hw, c, co in b4]
    # a 2048^2 sample call's decode at batch 2 (configs/pixart_kv2k.yaml): the input of the last level's first conv
    # is 2 x 2048 x 2048 x 256 = 2^31 elements
    decode_2k = [(256, 512, 512), (512, 512, 512), (1024, 512, 256), (1024, 256, 256), (2048, 256, 128),
                 (2048, 128, 128)]
    cases += [(f"b2_2k_{hw}_{c}_{co}", (2, hw, hw, c, co), ("bf16",)) for hw, c, co in decode_2k]
    encode = [(1024, 128, 128), (512, 128, 256), (512, 256, 256), (256, 256, 512), (256, 512, 512), (128, 512, 512)]
    cases += [(f"tiled_encode_{hw}_{c}_{co}", (1, hw, hw, c, co), ("bf16",)) for hw, c, co in encode]
    tile = [(72, 512, 512), (144, 512, 512), (288, 512, 256), (288, 256, 256), (576, 256, 128), (576, 128, 128)]
    cases += [(f"tile576_{hw}_{c}_{co}", (1, hw, hw, c, co), ("bf16",)) for hw, c, co in tile]
    # ragged against the 16 x 16 pixel tile, C = 32 (half a 64-channel chunk), C and Co = 96; batch 1 at 72² and
    # 144² is the tile decode above
    ragged = [(3, 31, 47, 128, 128), (2, 9, 21, 128, 256), (1, 17, 33, 32, 64), (1, 40, 24, 96, 96),
              (1, 3, 40, 96, 96), (1, 2, 3, 32, 32)]
    cases += [("ragged_" + "_".join(map(str, shape)), shape, ("bf16",)) for shape in ragged]
    # f32: the f32 DMD step's VAE encode at batch 2, 512² (the cldm step runs two); the shapes the f32 form was held
    # at before; this run's f32 paths: the small pipeline's encode and decode at 2 x 128² (the cldm step's encode
    # among them) and the depth-cut f32 server's at 1 x 512 x 640; ragged shapes
    dmd_encode = [(512, 128, 128), (256, 128, 256), (256, 256, 256), (128, 256, 512), (128, 512, 512), (64, 512, 512)]
    cases += [(f"dmd_encode_{hw}_{c}_{co}", (2, hw, hw, c, co), ("f32",)) for hw, c, co in dmd_encode]
    cases += [("b4_64_512_512", (4, 64, 64, 512, 512), ("f32",)),
              ("tile576_72_512_512", (1, 72, 72, 512, 512), ("f32",)),
              ("small_128_128_128", (2, 128, 128, 128, 128), ("f32",))]
    small = [(16, 512, 512), (32, 256, 512), (32, 512, 512), (64, 128, 256), (64, 256, 256), (64, 512, 256),
             (128, 256, 128)]
    cases += [(f"small_{hw}_{c}_{co}", (2, hw, hw, c, co), ("f32",)) for hw, c, co in small]
    served = [(64, 512, 512), (128, 256, 512), (128, 512, 512), (256, 128, 256), (256, 256, 256), (256, 512, 256),
              (512, 128, 128), (512, 256, 128)]
    cases += [(f"serve_{hw}_{c}_{co}", (1, hw, hw * 5 // 4, c, co), ("f32",)) for hw, c, co in served]
    cases += [("ragged_" + "_".join(map(str, shape)), shape, ("f32",)) for shape in ragged]
    # phase 17: extract_features' f32 VAE encode of 8 images at 512^2
    cases += [(f"extract_b8_{hw}_{c}_{co}", (8, hw, hw, c, co), ("f32",)) for hw, c, co in dmd_encode]
    # phase 20: the Reflow step's two f32 encodes and its decode under a gradient, at full width (2 x 512^2) and cut
    # to one res block a level (2 x 256^2), where not above
    f32_held = {shape for _, shape, dts in cases if "f32" in dts}
    cases += [(f"{run}_{'_'.join(map(str, shape[1:]))}", shape, ("f32",)) for shape, run in vae_grad_shapes("conv")
              if shape not in f32_held]
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
                # f32: the weight's split planes made once, as a module caches them; the prepass is timed apart
                planes = weight_planes(wk) if dt == "f32" else None
                out = gn_silu_conv3x3(x, gamma, beta, wk, bias, planes=planes)
                torch.cuda.synchronize()
                ref = gn_silu_conv3x3_plain(x, gamma, beta, wk, bias)
                err = max_err(out, ref)
                if not torch.isfinite(out).all():
                    fail(f"gn_conv {name} {dt}: kernel output is not finite")
                if not torch.equal(out, gn_silu_conv3x3(x, gamma, beta, wk, bias, planes=planes)):
                    fail(f"gn_conv {name} {dt}: two calls on the same inputs differ")
                del ref
                iters = 5 if n * h * w >= 2**20 else 10
                ms = cuda_ms(lambda: gn_silu_conv3x3(x, gamma, beta, wk, bias, planes=planes), iters=iters)
                a, b = gn_affine(x, gamma, beta)
                conv_ms = cuda_ms(lambda: gn_conv._launch(x, a, b, wk, bias, planes), iters=iters)
                plain_ms = cuda_ms(lambda: gn_silu_conv3x3_plain(x, gamma, beta, wk, bias), iters=3, warmup=1)
                lib_ms = cuda_ms(library, iters=iters)
                act = affine_silu_plain(x, a, b, silu=True).permute(0, 3, 1, 2)
                conv_lib_ms = cuda_ms(lambda: F.conv2d(act, w_oihw, biasl, padding=1), iters=iters)
                del act
            flops = 2.0 * n * h * w * 9 * c * co
            nbytes = x.element_size() * (x.numel() + wk.numel() + out.numel())
            b_ms, b_by = bound(nbytes, flops, dt, split=split_form(dt))
            rec = dict(name=name, dtype=dt, shape=[n, h, w, c, co], max_abs_err=err, bound=CONV_BOUNDS[dt], ms=ms,
                       includes="gn_stats_fold", conv_only_ms=conv_ms, conv_library_ms=conv_lib_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, tflops=flops / ms / 1e9,
                       conv_only_tflops=flops / conv_ms / 1e9, tile_n=tile_n(co), repeats_bits=True)
            if dt == "f32":  # the split prepass of a bare weight, and the bound at the f32 FMA rate beside
                rec["prepass_ms"] = cuda_ms(lambda: weight_planes(wk), iters=iters)
                rec["bound_fma_ms"] = bound(nbytes, flops, dt)[0]
            print(f"[gn_conv] {name:27s} {dt:4s} N,H,W,C,Co={n},{h},{w},{c},{co} max_abs_err={err:.3e} "
                  f"(bound {CONV_BOUNDS[dt]:.0e}) ms={ms:.4f} ({rec['tflops']:.1f} TFLOP/s; conv alone {conv_ms:.4f}, "
                  f"{rec['conv_only_tflops']:.1f} TFLOP/s; cuDNN conv alone {conv_lib_ms:.4f}) plain_ms={plain_ms:.4f} "
                  f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) tile_n={rec['tile_n']}"
                  + (f" prepass_ms={rec['prepass_ms']:.4f} bound_fma_ms={rec['bound_fma_ms']:.4f}" if dt == "f32" else ""),
                  flush=True)
            if not err <= CONV_BOUNDS[dt]:
                fail(f"gn_conv {name} {dt}: kernel differs from the plain version by {err} > {CONV_BOUNDS[dt]}")
            records.append(rec)
            del x, x_cl, wk, w_oihw, out, planes

    # A constant image with beta != 0 normalises to beta everywhere. With equal
    # weights an interior pixel sums 9 taps of silu(beta), an edge 6, a corner
    # 4; a halo of silu(b) instead of zero would give 9 everywhere.
    c = 64
    for dt in ("bf16", "f32"):
        dtype = getattr(torch, DTYPES[dt])
        x = torch.full((1, 8, 20, c), 0.5, device="cuda", dtype=dtype)
        beta = torch.full((c,), 1.5, device="cuda")
        wk = torch.full((3, 3, c, 32), 1.0 / c, device="cuda", dtype=dtype)
        out = gn_silu_conv3x3(x, torch.ones(c, device="cuda"), beta, wk, torch.zeros(32, device="cuda")).float()
        s = F.silu(beta[0]).to(dtype).float().item()
        for (yy, xx), taps in (((3, 9), 9), ((0, 0), 4), ((7, 19), 4), ((0, 5), 6), ((4, 19), 6), ((4, 0), 6)):
            got = out[0, yy, xx, 0].item()
            if abs(got - taps * s) > 2e-2 * taps * s:
                fail(f"gn_conv border {dt}: pixel ({yy}, {xx}) is {got}, expected {taps} taps of {s}: the halo is "
                     "not zero")
        print(f"[gn_conv] border case {dt}: corner 4, edge 6, interior 9 taps of silu(beta)={s:.4f}: "
              "the halo is zero", flush=True)
    return records


# K3's gradient on the card (the kernels forward, autograd through the plain
# version backward) against autograd through the plain version alone, per
# input, relative to the reference gradient's largest magnitude: the two run
# the same backward on the same inputs and cotangent, but cuDNN's backward
# convolutions may sum in other orders between calls. f32 1e-4; bf16 1e-2 (x's
# gradient is rounded to bf16: one step of its largest value is 3.9e-3).
CONV_GRAD_BOUNDS = {"bf16": 1e-2, "f32": 1e-4}


def conv_grad_phase():
    """All five gradients of K3 (x, gamma, beta, w, bias) through
    ``gn_silu_conv3x3`` on the card against autograd through
    ``gn_silu_conv3x3_plain``, bf16 and f32. Returns per-dtype records."""
    import torch

    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain

    records = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    n, h, w, c, co = 2, 40, 24, 128, 256
    for dt in ("f32", "bf16"):
        inputs = vae_inputs(gen, dt, n, h, w, c, co)
        cot = torch.randn(n, h, w, co, device="cuda", generator=gen).to(inputs[0].dtype)
        grads = {}
        for label, fn in (("kernel", gn_silu_conv3x3), ("plain", gn_silu_conv3x3_plain)):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            launches = gn_silu_conv3x3.launches
            out = fn(*leaves)
            if label == "kernel" and gn_silu_conv3x3.launches != launches + 1:
                fail(f"gn_conv grad {dt}: the forward did not launch the kernel")
            (out.float() * cot.float()).sum().backward()
            grads[label] = [t.grad.float() for t in leaves]
        errs = {name: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                for name, a, b in zip(("x", "gamma", "beta", "w", "bias"), grads["kernel"], grads["plain"])}
        print(f"[gn_conv] gradient {dt} N,H,W,C,Co={n},{h},{w},{c},{co}: kernel forward + plain backward against "
              f"autograd through the plain version, relative errors {({k: f'{v:.2e}' for k, v in errs.items()})} "
              f"(bound {CONV_GRAD_BOUNDS[dt]:.0e})", flush=True)
        if not max(errs.values()) <= CONV_GRAD_BOUNDS[dt]:
            fail(f"gn_conv gradient {dt}: {errs} over {CONV_GRAD_BOUNDS[dt]}")
        records.append(dict(dtype=dt, shape=[n, h, w, c, co], max_rel_err=errs, bound=CONV_GRAD_BOUNDS[dt]))
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
        # a 2048^2 sample call's decode at batch 2: every fused conv's moments, the mid block's and the output's
        # norms; (2, 2048, 2048, 256) is 2^31 elements
        *((f"b2_2k_{hw}_{c}", (2, hw, hw, c), ("bf16",)) for hw, c in
          ((256, 512), (512, 512), (1024, 512), (1024, 256), (2048, 256), (2048, 128))),
        # a 512^2 decode at batch 2 (the production training-validation eval, phase 19): every fused conv's
        # moments, the mid block's and the output's norms
        *((f"b2_{hw}_{c}", (2, hw, hw, c), ("bf16",)) for hw, c in
          ((64, 512), (128, 512), (256, 512), (256, 256), (512, 256), (512, 128))),
    ]
    # phase 20: every f32 moments shape (inside each fused conv, and the standalone norms, which also apply) of the
    # Reflow step's encodes and its decode under a gradient, where not above
    f32_held = {shape for _, shape, dts in shapes if "f32" in dts}
    shapes += [(f"{run}_{shape[1]}_{shape[3]}", shape, ("f32",)) for shape, run in vae_grad_shapes("stats")
               if shape not in f32_held]
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
                 ("swinir_b1_256_64", (1, 256, 256, 64)), ("swinir_b1_512_64", (1, 512, 512, 64)),
                 # a 2048^2 decode at batch 2; the last one's output is 2^31 elements
                 ("b2_2k_256_512", (2, 256, 256, 512)), ("b2_2k_512_512", (2, 512, 512, 512)),
                 ("b2_2k_1024_256", (2, 1024, 1024, 256)),
                 # a 512^2 decode at batch 2 (phase 19)
                 ("b2_64_512", (2, 64, 64, 512)), ("b2_128_512", (2, 128, 128, 512)), ("b2_256_256", (2, 256, 256, 256))]
    up_shapes = [(name, shape, "bf16") for name, shape in up_shapes]
    # phase 20: the f32 decodes under a gradient
    up_shapes += [(f"{run}_{shape[1]}_{shape[3]}", shape, "f32") for shape, run in vae_grad_shapes("up")]
    for name, (n, h, w, c), dt in up_shapes:
        x = torch.randn(n, h, w, c, device="cuda", generator=gen).to(getattr(torch, DTYPES[dt]))
        x_cl = x.permute(0, 3, 1, 2)
        out = upsample2x_nearest(x)
        torch.cuda.synchronize()
        err = max_err(out, upsample2x_nearest_plain(x))
        ms = cuda_ms(lambda: upsample2x_nearest(x))
        plain_ms = cuda_ms(lambda: upsample2x_nearest_plain(x))
        lib_ms = cuda_ms(lambda: F.interpolate(x_cl, scale_factor=2, mode="nearest"))
        moved = 5 * x.element_size() * x.numel()  # read once, written four times
        b_ms, b_by = bound(moved, 0.0, dt)
        rec = dict(name=name, dtype=dt, shape=[n, h, w, c], max_abs_err=err, bound=0.0, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, gbytes_per_s=moved / ms / 1e6)
        print(f"[upsample] {name:22s} {dt:4s} N,H,W,C={n},{h},{w},{c} max_abs_err={err:.1e} (exact) ms={ms:.4f} "
              f"({rec['gbytes_per_s']:.0f} GB/s) plain_ms={plain_ms:.4f} interpolate_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if err != 0.0:
            fail(f"upsample2x_nearest {name}: differs from the plain version by {err}")
        ups.append(rec)
        del x, x_cl, out
    return stats, applies, ups


def ptxas_figures(log: str, pattern: str, key) -> dict:
    """Registers and spill stores, from ptxas's lines in an nvcc log, of each
    kernel whose mangled name matches ``pattern``, under the prefix ``key``
    makes of the match (``{prefix}_registers``, ``{prefix}_spill_stores``)."""
    report = {}
    for fn_name, body in re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S):
        m = re.search(pattern, fn_name)
        if m:
            report[f"{key(m)}_registers"] = int(re.search(r"Used (\d+) registers", body).group(1))
            report[f"{key(m)}_spill_stores"] = int(re.search(r"(\d+) bytes spill stores", body).group(1))
    return report


def sass_counts(library: str, in_name: str = "", ops=("HGMMA", "UTMALDG", "HMMA")) -> dict:
    """HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync) instructions, or
    those of ``ops``, in the SASS of the built library's functions whose name
    holds ``in_name``."""
    import shutil

    from instarevive_tpu_torch.ops import cuda_build

    so = cuda_build.library_path(library, cuda_build.LIBRARIES[library])
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    text = "".join(part for part in sass.split("Function : ")[1:] if in_name in part.split("\n", 1)[0])
    return {op: text.count(op) for op in ops}


def occupancy_figures(library: str, entry: str, args, key) -> dict:
    """Shared memory a block and blocks an SM, from the library's occupancy
    entry called with each tuple of ``args``, under the prefix ``key(args)``."""
    import ctypes

    from instarevive_tpu_torch.ops import cuda_build

    fn = getattr(cuda_build.load_library(library), entry)
    fn.argtypes = [ctypes.c_int] * len(args[0]) + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    report = {}
    for a in args:
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        if fn(*a, ctypes.byref(smem), ctypes.byref(blocks)) != 0:
            fail(f"{entry}{a} failed")
        report[f"{key(a)}_smem_bytes"], report[f"{key(a)}_blocks_per_sm"] = smem.value, blocks.value
    return report


def hopper_build_report(log: str):
    """The forward as built: registers and spill stores of each head dim's
    bf16 kernel and of the f32 (split-tf32) kernels at 32, 64, 72 and 512
    (``f32_``; ptxas, when this run compiled it), the shared memory a block
    takes and the blocks an SM holds (the library's own figures), the counts
    of HGMMA (wgmma) and UTMALDG (TMA load) instructions in the library's
    SASS, in the bf16 head-dim-512 kernel's alone, in the f32 kernels' at 32,
    64 and 72 alone, in the f32 head-dim-32 kernel's alone and in the f32
    head-dim-512 kernel's alone, and the
    library's HMMA (mma.sync). Fails if the library or any of those kernels
    has no HGMMA or no UTMALDG, if an HMMA is left, or if a head-dim-512
    kernel or an f32 kernel spills."""
    report = ptxas_figures(log, r"hopper6kernelILi(\d+)E|d(512)6kernelE", lambda m: f"d{m.group(1) or m.group(2)}")
    report.update(ptxas_figures(log, r"fwd_tf326kernelILi(\d+)E|d(512)_tf326kernelE",
                                lambda m: f"f32_d{m.group(1) or m.group(2)}"))
    report.update(occupancy_figures("flash_attn_fwd", "flash_attn_fwd_occupancy", [(64,), (72,), (512,)],
                                    lambda a: f"d{a[0]}"))
    report.update(occupancy_figures("flash_attn_fwd", "flash_attn_fwd_occupancy_f32", [(32,), (64,), (72,), (512,)],
                                    lambda a: f"f32_d{a[0]}"))
    report.update(sass_counts("flash_attn_fwd"))
    for key, in_name in (("d512", "d5126kernel"), ("f32", "fwd_tf32"), ("f32_d512", "d512_tf326kernel"),
                         ("f32_d32", "fwd_tf326kernelILi32E")):
        counts = sass_counts("flash_attn_fwd", in_name)
        report[f"{key}_HGMMA"], report[f"{key}_UTMALDG"] = counts["HGMMA"], counts["UTMALDG"]
    print(f"[build] flash_attn_fwd.cu, the bf16 and split-tf32 forms: {report}", flush=True)
    counted = ("HGMMA", "UTMALDG", "d512_HGMMA", "d512_UTMALDG", "f32_HGMMA", "f32_UTMALDG", "f32_d512_HGMMA",
               "f32_d512_UTMALDG", "f32_d32_HGMMA", "f32_d32_UTMALDG")
    if not all(report[k] for k in counted):
        fail(f"the forward library's HGMMA and UTMALDG counts, all and by kernel: {({k: report[k] for k in counted})}")
    spills = {k: v for k, v in report.items() if k.endswith("_spill_stores") and v and k.startswith(("d512", "f32"))}
    if report["HMMA"] or spills:
        fail(f"the forward library has {report['HMMA']} HMMA instructions; spills {spills}")
    return report


def gn_conv_build_report(log: str):
    """The fused convolution as built, the bf16 form and the split-tf32 f32
    form (``f32_``): registers and spill stores of each channel tile (ptxas,
    when this run compiled it), the shared memory a block takes at C = 512
    and the blocks an SM holds (the library's own figures), and the counts of
    HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync) instructions in
    each form's SASS, and the f32 form's FFMA. Fails if either of the first
    two is 0 in a form, if an HMMA is left or if an f32 kernel spills."""
    report = ptxas_figures(log, r"gnconv_wg6kernelILi(\d+)E", lambda m: f"n{m.group(1)}")
    report.update(ptxas_figures(log, r"gnconv_tf326kernelILi(\d+)E", lambda m: f"f32_n{m.group(1)}"))
    cases = [(bn, 512) for bn in (64, 128)]
    report.update(occupancy_figures("gn_conv", "gn_silu_conv3x3_occupancy", cases, lambda a: f"n{a[0]}"))
    report.update(occupancy_figures("gn_conv", "gn_silu_conv3x3_occupancy_f32", cases, lambda a: f"f32_n{a[0]}"))
    report.update(sass_counts("gn_conv", "gnconv_wg"))
    report.update({f"f32_{k}": v for k, v in sass_counts("gn_conv", "gnconv_tf32", ("HGMMA", "UTMALDG", "HMMA",
                                                                                      "FFMA")).items()})
    print(f"[build] gn_conv.cu, the bf16 and split-tf32 forms: {report}", flush=True)
    spills = {k: v for k, v in report.items() if k.startswith("f32_") and k.endswith("_spill_stores") and v}
    if not all(report[k] for k in ("HGMMA", "UTMALDG", "f32_HGMMA", "f32_UTMALDG")) or report["HMMA"] \
            or report["f32_HMMA"] or spills:
        fail(f"the fused convolution's kernels have {report['HGMMA']} HGMMA, {report['UTMALDG']} UTMALDG and "
             f"{report['HMMA']} HMMA instructions (f32: {report['f32_HGMMA']}, {report['f32_UTMALDG']}, "
             f"{report['f32_HMMA']}); spills {spills}")
    return report


def bwd_build_report(log: str):
    """The backward as built: registers and spill stores of each pass at each
    head dim, bf16 and f32 (split-tf32, ``f32_``, also at head dim 32; ptxas,
    when this run compiled it), the shared memory a block takes and the blocks
    an SM holds (the library's own figures), and the counts of HGMMA (wgmma),
    UTMALDG (TMA load) and HMMA (mma.sync) instructions in each form's
    kernels' SASS and in the f32 head-dim-32 kernels' alone (``f32_d32_``).
    Fails if either of the first two is 0 in a form, if an HMMA is left or if
    a kernel spills."""
    pass_of = lambda m: f"{'dkv' if m.group(2) == '1' else 'dq'}_d{m.group(1)}"  # noqa: E731
    report = ptxas_figures(log, r"bwd166kernelILi(\d+)ELb([01])E", pass_of)
    report.update(ptxas_figures(log, r"bwd_tf326kernelILi(\d+)ELb([01])ELi(\d)E",
                                lambda m: f"f32_{pass_of(m)}_wg{m.group(3)}"))
    report.update(ptxas_figures(log, r"bwd512_tf326kernelILb([01])E",
                                lambda m: f"f32_{'dkv' if m.group(1) == '1' else 'dq'}_d512"))
    cases = [(d, kv) for kv in (0, 1) for d in (64, 72)]
    report.update(occupancy_figures("flash_attn_bwd", "flash_attn_bwd_occupancy", cases,
                                    lambda a: f"{'dkv' if a[1] else 'dq'}_d{a[0]}"))
    report.update(occupancy_figures("flash_attn_bwd", "flash_attn_bwd_occupancy_f32",
                                    [(d, kv, wg) for kv in (0, 1) for d in (32, 64, 72) for wg in (1, 2)]
                                    + [(512, kv, 2) for kv in (0, 1)],
                                    lambda a: f"f32_{'dkv' if a[1] else 'dq'}_d{a[0]}_wg{a[2]}"))
    report.update(sass_counts("flash_attn_bwd", "bwd16"))
    report.update({f"f32_{k}": v for k, v in sass_counts("flash_attn_bwd", "bwd_tf32").items()})
    report.update({f"f32_d32_{k}": v for k, v in sass_counts("flash_attn_bwd", "bwd_tf326kernelILi32E").items()})
    report.update({f"f32_d512_{k}": v for k, v in sass_counts("flash_attn_bwd", "bwd512_tf32").items()})
    print(f"[build] flash_attn_bwd.cu, the bf16 and split-tf32 forms: {report}", flush=True)
    spills = {k: v for k, v in report.items() if k.endswith("_spill_stores") and v}
    if not all(report[k] for k in ("HGMMA", "UTMALDG", "f32_HGMMA", "f32_UTMALDG", "f32_d32_HGMMA", "f32_d32_UTMALDG",
                                   "f32_d512_HGMMA", "f32_d512_UTMALDG")) \
            or report["HMMA"] or report["f32_d512_HMMA"] \
            or report["f32_HMMA"] or spills:
        fail(f"the backward's kernels have {report['HGMMA']} HGMMA, {report['UTMALDG']} UTMALDG and "
             f"{report['HMMA']} HMMA instructions (f32: {report['f32_HGMMA']}, {report['f32_UTMALDG']}, "
             f"{report['f32_HMMA']}); spills {spills}")
    return report


# The plain attention holds its (B, H, Nq, Nk) f32 scores in device memory;
# above this many bytes it runs in query chunks (a 2K self-attention's
# scores would take 69 GB at once).
PLAIN_SCORES_BYTES = 2**32


def sdpa_by_query_chunks(q, k, v, mask=None):
    """``sdpa`` over chunks of query rows whose scores stay under
    PLAIN_SCORES_BYTES: a row's output reads its own scores only."""
    import torch

    from instarevive_tpu_torch.ops.attention import sdpa

    b, h, nq, _ = q.shape
    rows = max(1, PLAIN_SCORES_BYTES // (4 * b * h * k.shape[2]))
    if rows >= nq:
        return sdpa(q, k, v, kv_mask=mask)
    return torch.cat([sdpa(q[:, :, i:i + rows], k, v, kv_mask=mask) for i in range(0, nq, rows)], dim=2)


def library_sdpa_ms(q, k, v, attn_mask, large):
    """ms of one ``F.scaled_dot_product_attention`` on these inputs; at a
    large shape only its fused backends (the math one would hold the whole
    score matrix)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not large:
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), iters=5)


def kernel_phase():
    """K1 against sdpa at the main-path shapes; returns per-shape records.
    At the f32 DMD encode's shape ``sdpa`` with TF32 matmuls is held too and
    must land outside the f32 bound, so the bound tells split-tf32 products
    from plain TF32 ones."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops.attention import flash_attention, sdpa

    cases = [  # (name, (B, H, Nq, Nk, D), keys kept per sample or None for no mask, dtypes)
        ("dit_self", (4, 16, 1024, 1024, 72), None, ("bf16", "f32")),
        ("dit_cross", (4, 16, 1024, 300, 72), None, ("bf16", "f32")),
        ("dit_cross_masked", (4, 16, 1024, 300, 72), (300, 180, 0, 61), ("bf16", "f32")),  # one row with no key
        ("vae_mid", (4, 1, 4096, 4096, 512), None, ("bf16",)),                  # process at 4 x 512^2
        ("dit_self_tile576", (4, 16, 1296, 1296, 72), None, ("bf16",)),
        ("ragged_q1000_k77_masked", (1, 16, 1000, 77, 72), (51,), ("bf16", "f32")),
        ("ragged_q1000_k333", (1, 16, 1000, 333, 72), None, ("bf16",)),
        ("vae_mid_tiled_encode", (1, 1, 16384, 16384, 512), None, ("bf16",)),   # the tiled 1024^2 call's encode
        ("vae_mid_tile576_decode", (1, 1, 5184, 5184, 512), None, ("bf16",)),   # its decode, one 72^2 latent tile
        ("ragged_d512_masked", (2, 1, 1000, 333, 512), (199, 0), ("bf16", "f32")),
        ("vae_mid_dmd_encode", (2, 1, 4096, 4096, 512), None, ("f32",)),        # an f32 DMD step's frozen-VAE encode
        # batch 2 without guidance: the validation DiT (bf16) and the depth-cut f32 sample and control runs
        ("dit_self_b2", (2, 16, 1024, 1024, 72), None, ("bf16", "f32")),
        ("dit_cross_b2", (2, 16, 1024, 300, 72), None, ("bf16", "f32")),
        ("vae_mid_b2", (2, 1, 4096, 4096, 512), None, ("bf16",)),               # a sample call's decode, validate's
        # configs/pixart_kv2k.yaml at 2048x2048, two prompts under guidance (DiT batch 4, a 128 x 128 token grid):
        # blocks 14-27 over every key, blocks 0-13 over K and V compressed 2x a side, the cross attention; its decode
        ("dit2k_self", (4, 16, 16384, 16384, 72), None, ("bf16",)),
        ("dit2k_self_kv_compressed", (4, 16, 16384, 4096, 72), None, ("bf16",)),
        ("dit2k_cross", (4, 16, 16384, 300, 72), None, ("bf16",)),
        ("vae_mid_2k_b2", (2, 1, 65536, 65536, 512), None, ("bf16",)),
        # the f32 DiT with every option, card against CPU (phase 15): a 12 x 20 token grid, its compressed keys, an
        # 8-token window over the grid padded to 16 x 24, the cross attention
        ("options_self_kv_compressed", (2, 16, 240, 60, 72), None, ("f32",)),
        ("options_window", (12, 16, 64, 64, 72), None, ("f32",)),
        ("options_cross", (2, 16, 240, 300, 72), None, ("f32",)),
        # phase 17: the ViT of DPT-Hybrid and DPT-Large at 384^2 (577 tokens, head dim 64; f32 on the path, bf16 for
        # the table), and extract_features' f32 VAE encode of 8 images at 512^2
        ("dpt_hybrid_self", (2, 12, 577, 577, 64), None, ("bf16", "f32")),
        ("dpt_large_self", (2, 16, 577, 577, 64), None, ("bf16", "f32")),
        ("vae_mid_extract_b8", (8, 1, 4096, 4096, 512), None, ("f32",)),
        # phase 18, two ranks: tensor parallelism (8 of the 16 heads a rank), sequence parallelism (512 local queries
        # over 1,024 gathered keys); pipeline parallelism's two microbatches are dit_self_b2 and dit_cross_b2
        ("tp2_self", (4, 8, 1024, 1024, 72), None, ("bf16",)),
        ("tp2_cross", (4, 8, 1024, 300, 72), None, ("bf16",)),
        ("sp2_self", (4, 16, 512, 1024, 72), None, ("bf16",)),
        ("sp2_cross", (4, 16, 512, 300, 72), None, ("bf16",)),
    ]
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    records = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, h, nq, nk, d), kept, dts in cases:
        masked = kept is not None
        for dt in dts:
            q = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtypes[dt])
            k = torch.randn(b, h, nk, d, device="cuda", generator=gen).to(dtypes[dt])
            v = (torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1).to(dtypes[dt])
            mask = None if kept is None else torch.arange(nk, device="cuda")[None] < torch.tensor(kept, device="cuda")[:, None]
            large = 4 * b * h * nq * nk > PLAIN_SCORES_BYTES  # the plain version in query chunks, fewer timed runs
            with torch.no_grad():
                out = flash_attention(q, k, v, kv_mask=mask)
                torch.cuda.synchronize()
                ref = sdpa_by_query_chunks(q, k, v, mask)
                err = (out.float() - ref.float()).abs().max().item()
                ref_max = ref.float().abs().max().item()
                if not torch.isfinite(out).all():
                    fail(f"{name} {dt}: kernel output is not finite")
                ms = cuda_ms(lambda: flash_attention(q, k, v, kv_mask=mask), iters=5 if large else 20)
                plain_ms = cuda_ms(lambda: sdpa_by_query_chunks(q, k, v, mask), *((2, 1) if large else ()))
                attn_mask = None if mask is None else mask[:, None, None, :]
                lib_ms = library_sdpa_ms(q, k, v, attn_mask, large)
            # the work this run's data needs: masked keys take no product
            keys = b * nk if mask is None else int(mask.sum().item())
            flops = 4.0 * h * nq * keys * d
            b_ms, b_by = bound(q.element_size() * (2 * q.numel() + 2 * k.numel()), flops, dt, split_form(dt))
            limit = min(BOUNDS[dt], REL_BOUNDS[dt] * ref_max)
            rec = dict(name=name, dtype=dt, shape=[b, h, nq, nk, d], masked=masked,
                       max_abs_err=err, bound=BOUNDS[dt], ref_max_abs=ref_max, rel_bound=REL_BOUNDS[dt], ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, tflops=flops / ms / 1e9)
            print(f"[kernel] {name:23s} {dt:4s} B,H,Nq,Nk,D={b},{h},{nq},{nk},{d} "
                  f"mask={masked!s:5s} max_abs_err={err:.3e} (bound {BOUNDS[dt]:.0e} and {REL_BOUNDS[dt]:.0e} of "
                  f"max|ref| {ref_max:.3e}) "
                  f"ms={ms:.4f} ({flops / ms / 1e9:.0f} TFLOP/s) sdpa_ms={plain_ms:.4f} "
                  f"torch_sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})", flush=True)
            if not err <= limit:
                fail(f"{name} {dt}: kernel differs from sdpa by {err} > min({BOUNDS[dt]}, {REL_BOUNDS[dt]} * {ref_max})")
            if name == "vae_mid_dmd_encode":  # sdpa in plain TF32 must fail the bound the kernel passes
                kept_tf32, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, True
                try:
                    with torch.no_grad():
                        rec["tf32_sdpa_max_abs_err"] = max_err(sdpa(q, k, v, kv_mask=mask), ref)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = kept_tf32
                print(f"[kernel] {name:23s} {dt:4s} sdpa with TF32 matmuls: max_abs_err={rec['tf32_sdpa_max_abs_err']:.3e}, "
                      f"the kernel's {err:.3e}, the bound {limit:.3e}", flush=True)
                if not rec["tf32_sdpa_max_abs_err"] > limit:
                    fail(f"{name}: sdpa with TF32 matmuls is within the f32 bound ({rec['tf32_sdpa_max_abs_err']} <= {limit})")
            records.append(rec)
            del q, k, v, out, ref
    return records


# The production training-validation tool's teacher steps at XL-2 width (batch 4, no mask; phase 19): bf16 in its
# stages, f32 in its depth-cut step held against the CPU
TRAINVAL_BACKWARD_CASES = [
    ("dit_self_b4", (4, 16, 1024, 1024, 72), None),
    ("dit_cross_b4", (4, 16, 1024, 300, 72), None),
]


def backward_phase():
    """K2 (the dq and dk/dv kernels) and K1's log-sum-exp output against their
    plain versions at the shapes of a DMD train step (batch 2), a masked
    cross-attention, a ragged shape and the production training-validation
    teacher's batch 4, bf16 and f32; the same inputs twice
    give the same bits. The yardstick is the backward (alone) of
    ``F.scaled_dot_product_attention`` through autograd. Returns (dq records,
    dk/dv records, K1-with-LSE records)."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.tools.time_flash_bwd import BACKWARD_CASES

    dq_records, dkv_records, lse_records = [], [], []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, (b, h, nq, nk, d), kept in BACKWARD_CASES + TRAINVAL_BACKWARD_CASES:
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
            es, split = q.element_size(), split_form(dt)
            b_dq = bound(es * (3 * q.numel() + 2 * k.numel()) + 8 * lse.numel(), 6.0 * pairs * d, dt, split)
            b_dkv = bound(es * (2 * q.numel() + 4 * k.numel()) + 8 * lse.numel(), 8.0 * pairs * d, dt, split)
            b_both = bound(es * (4 * q.numel() + 4 * k.numel()), 10.0 * pairs * d, dt, split)
            b_fwd = bound(es * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel(), 4.0 * pairs * d, dt, split)
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


# The shapes the f32 attention's split prepass takes on the main f32 paths: a DMD step's DiT operands at batch 2 (q
# and dO as queries, k and v as keys, 1024 self and 300 cross), the UNet's ds-1 and the 77-key context, a ragged
# Nq = 1000, the VAE mid block's K (natural) and V (transposed) at the f32 DMD encode's head dim 512, and a ragged
# head-dim-512 operand: (name, (B, H, N, D), natural, transposed)
PLANES_CASES = [
    ("dit_q_b2", (2, 16, 1024, 72), True, True),
    ("dit_cross_k_b2", (2, 16, 300, 72), True, True),
    ("dit_cross_v_b2", (2, 16, 300, 72), False, True),
    ("unet_ds1_q", (2, 5, 4096, 64), True, True),
    ("unet_k77", (2, 5, 77, 64), True, True),
    ("ragged_q1000", (1, 16, 1000, 72), True, True),
    ("vae_k_dmd_encode", (2, 1, 4096, 512), True, False),
    ("vae_v_dmd_encode", (2, 1, 4096, 512), False, True),
    ("ragged_d512_k333", (2, 1, 333, 512), True, True),
    # the toy DiT of tools/train_validation.py at head dim 32: its queries and keys, and the 4 caption keys
    ("toy_q_d32", (64, 4, 64, 32), True, True),
    ("toy_cross_k_d32", (64, 4, 4, 32), True, True),
]


def planes_phase():
    """The split prepass (``tf32_planes``) against ``tf32_planes_plain`` by
    ``torch.equal`` (every plane asked for, bit for bit) on values over many
    binades, ties included, at the shapes of PLANES_CASES; timed beside the
    plain version, no library call computing it. Returns per-shape records."""
    import torch

    from instarevive_tpu_torch.ops.tf32_planes import pad8, tf32_planes, tf32_planes_plain

    records = []
    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, shape, natural, transposed in PLANES_CASES:
        x = torch.randn(shape, device="cuda", generator=gen) * torch.exp(4 * torch.randn(shape, device="cuda", generator=gen))
        x.view(-1)[:3] = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11], device="cuda")
        got = tf32_planes(x, natural, transposed)
        torch.cuda.synchronize()
        want = tf32_planes_plain(x, natural, transposed)
        same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want))
        ms = cuda_ms(lambda: tf32_planes(x, natural, transposed))
        plain_ms = cuda_ms(lambda: tf32_planes_plain(x, natural, transposed), iters=5, warmup=1)
        *lead, n, d = shape
        written = (2 * x.numel() if natural else 0) + (2 * x.numel() // n * pad8(n) if transposed else 0)
        b_ms, b_by = bound(4 * (x.numel() + written), 0.0, "f32")
        records.append(dict(name=name, dtype="f32", shape=list(shape), natural=natural, transposed=transposed,
                            bitwise_equal=same, max_abs_err=0.0 if same else float("inf"), ms=ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=b_ms, bound_by=b_by, gbytes_per_s=4 * (x.numel() + written) / ms / 1e6))
        print(f"[planes] {name:15s} {tuple(shape)} natural={natural!s:5s} transposed={transposed!s:5s} "
              f"bit for bit={same} ms={ms:.4f} ({records[-1]['gbytes_per_s']:.0f} GB/s) plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not same:
            fail(f"tf32_planes {name}: the prepass differs from tf32_planes_plain")
        del x, got, want
    return records


def swin_build_report(log: str):
    """K4 as built, both forms (bf16 ``swin16``, f32 ``swin_tf32``): registers
    and spill stores (ptxas, when this run compiled it), the heads a work
    item takes at ``process``'s 256 windows, the shared memory a block takes
    then, the ring's slots and the blocks an SM holds (the library's own
    figures), and the counts of mma.sync (HMMA), ldmatrix (LDSM) and cp.async
    (LDGSTS: the copies into the tiles) instructions in each form's SASS.
    Fails if a form has none of one of them, or spills."""
    import ctypes

    import torch

    from instarevive_tpu_torch.ops import cuda_build
    from instarevive_tpu_torch.ops.swin_attention import heads_per_item

    report = ptxas_figures(log, r"swin16(6)kernel|swin_tf32(6)kernel", lambda m: "bf16" if m.group(1) else "f32")
    fn = cuda_build.load_library("swin_attention").swin_window_attention_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key, bf16 in (("bf16", True), ("f32", False)):
        g = heads_per_item(6, 30, 256, sms, bf16)
        got = [ctypes.c_int() for _ in range(3)]
        if fn(g, 30, int(bf16), *(ctypes.byref(x) for x in got)) != 0:
            fail(f"swin_window_attention_occupancy({g}, 30, {int(bf16)}) failed")
        smem, slots, blocks = (x.value for x in got)
        report.update({f"{key}_heads_per_item": g, f"{key}_smem_bytes": smem, f"{key}_slots": slots,
                       f"{key}_blocks_per_sm": blocks})
        counts = sass_counts("swin_attention", "swin16" if bf16 else "swin_tf32", ("HMMA", "LDSM", "LDGSTS"))
        report.update({f"{key}_{op}": n for op, n in counts.items()})
    print(f"[build] swin_attention.cu, the bf16 and split-tf32 forms: {report}", flush=True)
    spills = {k: v for k, v in report.items() if k.endswith("_spill_stores") and v}
    missing = [f"{key}_{op}" for key in ("bf16", "f32") for op in ("HMMA", "LDSM", "LDGSTS") if not report[f"{key}_{op}"]]
    if missing or spills:
        fail(f"the window attention's kernels lack {missing} or spill {spills}")
    return report


def filter_build_report(log: str):
    """K6 as built: registers and spill stores of each instantiation
    (``e{band width}_r{rows}``; ptxas, when this run compiled it), the plan
    its launcher picks at the degradation shapes (``filter2d_plan``: band
    width, rows a thread, tiles, shared memory a block, blocks an SM), and
    the FFMA, LDS and LDGSTS counts and all instructions of the main path's
    instantiation (3 channels, 4 rows) in the library's SASS, and the FFMA and
    all instructions of its innermost loop with the most FFMA (a chunk of 4
    taps). Fails on a spill or a count of 0."""
    import shutil

    from instarevive_tpu_torch.ops import cuda_build
    from instarevive_tpu_torch.ops.filters import filter2d_plan
    from instarevive_tpu_torch.tools.time_degrade import FILTER_CASES

    report = ptxas_figures(log, r"filter2d_kernelILi(\d)ELi(\d)E", lambda m: f"e{m.group(1)}_r{m.group(2)}")
    for name, shape, taps, _ in FILTER_CASES[:4]:
        report[f"{name}_plan"] = filter2d_plan(shape, taps)
    so = cuda_build.library_path("filter2d", cuda_build.LIBRARIES["filter2d"])
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    text = "".join(part for part in sass.split("Function : ")[1:] if "filter2d_kernelILi3ELi4E" in part.split("\n", 1)[0])
    ins = [(int(addr, 16), op.split(".")[0], rest) for addr, op, rest in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", text)]
    ops = [op for _, op, _ in ins]
    report.update({f"e3_r4_{op}": ops.count(op) for op in ("FFMA", "LDS", "LDGSTS")}, e3_r4_instructions=len(ops))
    # the innermost loop with the most FFMA (a full chunk of 4 taps): its FFMA among all its instructions
    loops = [(int(m.group(1), 16), addr) for addr, op, rest in ins if op == "BRA"
             for m in [re.search(r"0x([0-9a-f]+)", rest)] if m and int(m.group(1), 16) < addr]
    inner = [(lo, hi) for lo, hi in loops if not any(lo <= lo2 and hi2 < hi for lo2, hi2 in loops)]
    bodies = [[op for addr, op, _ in ins if lo <= addr <= hi] for lo, hi in inner]
    if bodies:
        body = max(bodies, key=lambda b: (b.count("FFMA"), b.count("FFMA") / len(b)))
        report.update(e3_r4_loop_FFMA=body.count("FFMA"), e3_r4_loop_instructions=len(body))
    print(f"[build] filter2d.cu: {report}", flush=True)
    spills = {k: v for k, v in report.items() if k.endswith("_spill_stores") and v}
    if spills or not all(report[f"e3_r4_{op}"] for op in ("FFMA", "LDS", "LDGSTS")):
        fail(f"the 2-D filter's kernels spill {spills} or lack FFMA, LDS or LDGSTS: {report}")
    return report


def swin_phase():
    """K4 against its plain version (roll, partition, ``sdpa``, reverse, roll
    back) at every shape the main path, the CLI and the server give it, plus
    non-square maps and batch 1, in bf16 and f32, shifted with the mask and
    unshifted without, and at the odd shifts 3 and 5 (whose window rows start
    at odd pixels: the kernel's cp.async copies) at two shapes; each kernel
    output twice, for the same bits. Yardsticks: ``library_ms`` is one
    ``F.scaled_dot_product_attention`` call with the additive mask on already
    partitioned (B * nW, heads, 64, hd) tensors; ``library_composition_ms``
    is the whole composition around that call (roll, partition, head split,
    the call, reverse, roll back). Returns per-shape records."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import window as W
    from instarevive_tpu_torch.ops.swin_attention import swin_window_attention, swin_window_attention_plain

    heads, hd, win = 6, 30, 8
    c, n, scale = heads * hd, win * win, hd**-0.5
    both, odd = ("bf16", "f32"), (0, win // 2, 3, 5)
    cases = [  # (name, (B, H, W), dtypes, shifts)
        ("process_b4_64x64", (4, 64, 64), both, odd),
        ("tiled_b1_128x128", (1, 128, 128), both, (0, win // 2)),
        ("one_512_b1_64x64", (1, 64, 64), both, odd),
        ("serve_b2_64x64", (2, 64, 64), both, (0, win // 2)),
        ("serve_b3_64x64", (3, 64, 64), both, (0, win // 2)),
        ("serve_b1_64x80", (1, 64, 80), both, (0, win // 2)),
        ("cli_b1_64x104", (1, 64, 104), both, (0, win // 2)),
        ("nonsquare_b1_64x48", (1, 64, 48), both, (0, win // 2)),
        ("nonsquare_b2_64x48", (2, 64, 48), both, (0, win // 2)),
        ("small_b2_16x16", (2, 16, 16), both, (0, win // 2)),
        ("vae_grad_cut_b2_32x32", (2, 32, 32), ("f32",), (0, win // 2)),  # phase 20's cut run: 256^2 unshuffled by 8
        ("residual_b4_512x512", (4, 512, 512), ("bf16",), (0, win // 2)),  # phase 16's SwinIR without unshuffle
    ]
    records = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, (b, h, w), dts, shifts in cases:
        for dt in dts:
            for shift in shifts:
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
                    again = swin_window_attention(qkv, bias, mask, heads, win, scale, shift)
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
                b_ms, b_by = bound(nbytes, 4.0 * windows * heads * n * n * hd, dt, split_form(dt))
                shifted = {0: "unshifted", win // 2: "shifted"}.get(shift, f"shift{shift}")
                rec = dict(name=f"{name}_{shifted}", dtype=dt, shape=[b, h, w, 3 * c],
                           shift=shift, masked=mask is not None, max_abs_err=err, bound=SWIN_BOUNDS[dt],
                           max_abs_err_vs_f32=err32, library_max_abs_err_vs_f32=lib_err, repeats_bits=torch.equal(out, again),
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library_composition_ms=comp_ms, bound_ms=b_ms,
                           bound_by=b_by, gbytes_per_s=nbytes / ms / 1e6)
                print(f"[swin_attn] {rec['name']:30s} {dt:4s} B,H,W,3C={b},{h},{w},{3 * c} shift={shift} "
                      f"max_abs_err={err:.3e} (bound {SWIN_BOUNDS[dt]:.0e}) vs_f32_reference={err32:.3e} "
                      f"(library's {lib_err:.3e}) same_bits={rec['repeats_bits']} ms={ms:.4f} "
                      f"({rec['gbytes_per_s']:.0f} GB/s) plain_ms={plain_ms:.4f} "
                      f"torch_sdpa_ms={lib_ms:.4f} with_partition_and_rolls_ms={comp_ms:.4f} "
                      f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
                if not err <= SWIN_BOUNDS[dt]:
                    fail(f"swin_window_attention {name} {dt} shift={shift}: kernel differs from the plain version "
                         f"by {err} > {SWIN_BOUNDS[dt]}")
                if dt == "bf16" and not err32 <= SWIN_F32_REF_BOUND:
                    fail(f"swin_window_attention {name} shift={shift}: bf16 kernel is {err32} from the f32 "
                         f"reference, over {SWIN_F32_REF_BOUND}")
                if not rec["repeats_bits"]:
                    fail(f"swin_window_attention {name} {dt} shift={shift}: two runs gave other bits")
                records.append(rec)
                del qkv, q, k, v, add, out, again, ref, ref32
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
    """Every kernel count to 0, the split prepass's too (it counts apart: f32
    runs alone launch it), and its tally by shape to an empty dict."""
    from instarevive_tpu_torch.ops.tf32_planes import tf32_planes

    for fn in (*counters().values(), tf32_planes):
        fn.launches = 0
    tf32_planes.shapes = {}


def conv_weight_planes() -> int:
    """The split prepass's launches since the last reset that packed a conv
    weight: its tally's (Co, 9, C) natural-only shapes (``weight_planes``;
    the attention's operands have sequences longer than 9)."""
    from instarevive_tpu_torch.ops.tf32_planes import tf32_planes

    if sum(tf32_planes.shapes.values()) != tf32_planes.launches:
        fail(f"tf32_planes: {tf32_planes.shapes} tallied by shape, {tf32_planes.launches} counted")
    return sum(k for (_, n, _, natural, transposed), k in tf32_planes.shapes.items()
               if n == 9 and natural and not transposed)


def f32_launches(fwd_split: int, fwd_d512: int, what: str, convs: int = 0, conv_modules: int = 0) -> dict:
    """The launches of an f32 run on the card since the last reset: the f32
    attention forms (the forward at head dims 64/72, fwd_split of them, and
    at 512, fwd_d512; both backward passes), K3's f32 form (``convs`` of
    them) and the split prepass, three a forward at 64/72 (q, k, v), two at
    512 (k, v: q goes raw), four a backward (q, k, v, dO) and one for each
    of the ``conv_modules`` K3 convs the run called first (their weight
    planes are packed once per module). Fails if the prepass ran another
    number of times for either, K3 another number than ``convs``, or the run
    launched no split-tf32 kernel at 64/72."""
    from instarevive_tpu_torch.ops.tf32_planes import tf32_planes

    got = read_counts()
    weights = conv_weight_planes()
    out = {"flash_attn_fwd_f32": fwd_split, "flash_attn_fwd_f32_d512": fwd_d512,
           "flash_attn_bwd_dq_f32": got["flash_attn_bwd_dq"], "flash_attn_bwd_dkv_f32": got["flash_attn_bwd_dkv"],
           "gn_silu_conv3x3_f32": got["gn_silu_conv3x3"], "tf32_planes": tf32_planes.launches,
           "tf32_planes_conv_weights": weights}
    attention_planes = 3 * fwd_split + 2 * fwd_d512 + 4 * got["flash_attn_bwd_dq"]
    if fwd_split + fwd_d512 != got["flash_attn_fwd"] or got["flash_attn_bwd_dq"] != got["flash_attn_bwd_dkv"] \
            or out["tf32_planes"] - weights != attention_planes or weights != conv_modules or not fwd_split \
            or got["gn_silu_conv3x3"] != convs:
        fail(f"{what}: f32 launches {out} against the counts {got}, {conv_modules} conv weights to pack")
    return out


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def expected_counts(pipe, dit_forwards: int, encodes: int, decodes: int, cleans: int = 1, control_depth: int = 0):
    """Launches the configuration implies: per SwinIR forward one window
    attention for every block and one upsample for every step of its
    upsampler; per VAE encode 2 fused convs for
    each of levels * blocks + 2 ResnetBlocks, per decode levels * (blocks + 1)
    + 2; one moments launch inside every fused conv and one for each of the
    two standalone norms of an encode or a decode, which also launch the
    apply kernel; levels - 1 upsamples per decode; attention twice per DiT
    block (``control_depth`` ControlNet-Half copies included) and once per VAE
    mid block. Inference launches no backward kernel and no degradation
    filter."""
    levels, blocks = len(pipe.vae.ch_mult), len(pipe.vae.encoder.down[0].block)
    convs = encodes * 2 * (levels * blocks + 2) + decodes * 2 * (levels * (blocks + 1) + 2)
    norms = 2 * (encodes + decodes)
    swin_blocks = sum(len(layer.residual_group.blocks) for layer in pipe.swinir.layers)
    return {"flash_attn_fwd": dit_forwards * 2 * (pipe.dit.depth + control_depth) + encodes + decodes,
            "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0, "gn_silu_conv3x3": convs,
            "gn_stats_fold": convs + norms, "gn_apply": norms,
            "upsample2x": decodes * (levels - 1) + cleans * len(pipe.swinir.ups),
            "swin_window_attention": cleans * swin_blocks, "filter2d": 0}


def check_counts(what: str, pipe, dit_forwards: int, encodes: int, decodes: int, cleans: int = 1):
    got, want = read_counts(), expected_counts(pipe, dit_forwards, encodes, decodes, cleans)
    if got != want:
        fail(f"{what}: kernel launches {got}, expected {want}")
    return got


def small_pipeline_phase(cfg_full, conv_records):
    """Full widths, cut depth: f32 on the card against f32 on the CPU; the f32
    run's fused convolutions (K3's f32 form) tallied by shape."""
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
        if label == "f32":
            outs[label] = tally_shapes(lambda: gpu.process(lq.cuda(), y.cuda()), "small pipeline f32", conv_records,
                                       None, "launches_small_pipeline", conv_dtype="f32").cpu()
        else:
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


def tally_shapes(call, what, conv_records, swin_records, key=None, attn_records=None, conv_dtype="bf16",
                 attn_dims=(512,), filter_records=None):
    """Run ``call`` with every kernel count at 0 and (unless their records
    are None) the window attention, the fused convolution, (with
    ``attn_records``) the flash-attention forward at the head dims
    ``attn_dims`` and (with ``filter_records``) the 2-D filter tallying their
    launches by shape. Every shape the call gave a tallied kernel must be one
    its phase held against the plain version, the convolution's and the
    attention's in ``conv_dtype`` (an f32 run's in f32); with ``key``, the
    measured count goes into that record under it. Returns the call's
    output."""
    import torch

    from instarevive_tpu_torch.ops.attention import flash_attention
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3
    from instarevive_tpu_torch.ops.swin_attention import swin_window_attention

    # (wrapper, legend, held shape -> record, which tallied shapes must be held: None for all)
    tallied = []
    if swin_records is not None:
        tallied.append((swin_window_attention, "(B, H, W, 3C, shift, masked)",
                        {(*r["shape"], r["shift"], r["masked"]): r for r in swin_records if r["dtype"] == "bf16"}, None))
    if conv_records is not None:
        tallied.append((gn_silu_conv3x3, "(N, H, W, C, Co, dtype)",
                        {(*r["shape"], r["dtype"]): r for r in conv_records if r["dtype"] == conv_dtype}, None))
    if attn_records is not None:  # the other head dims' shapes are counted but not held here
        tallied.append((flash_attention, f"(B, H, Nq, Nk, D, masked, with log-sum-exp) at D in {attn_dims}",
                        {(*r["shape"], r["masked"], False): r for r in attn_records
                         if r["dtype"] == conv_dtype and r["shape"][4] in attn_dims},
                        lambda shape: shape[4] in attn_dims))
    if filter_records is not None:
        from instarevive_tpu_torch.ops.filters import filter2d

        tallied.append((filter2d, "(B, H, W, C, kh, kw, per-sample)",
                        {(*r["shape"], *r["taps"], r["per_sample"]): r for r in filter_records}, None))
    reset_counts()
    for fn, _, _, _ in tallied:
        fn.shapes = {}
    try:
        out = call()
        torch.cuda.synchronize()
        seen = [fn.shapes for fn, _, _, _ in tallied]
    finally:
        for fn, _, _, _ in tallied:
            fn.shapes = None
    for (fn, legend, held, selected), shapes in zip(tallied, seen):
        if sum(shapes.values()) != fn.launches:
            fail(f"{what}: {fn.__name__}: {sum(shapes.values())} launches tallied by shape, {fn.launches} counted")
        if selected is not None:
            shapes = {shape: n for shape, n in shapes.items() if selected(shape)}
        missing = sorted(set(shapes) - set(held))
        if missing:
            fail(f"{what}: {fn.__name__} ran at shapes its kernel phase did not hold: {missing}")
        if key is not None:
            for shape, rec in held.items():
                rec[key] = shapes.get(shape, 0)
        print(f"[pipeline] {what}: {fn.__name__} launches by {legend}: "
              + ", ".join(f"{k}x{v}" for k, v in sorted(shapes.items())), flush=True)
    return out


def check_d512(attn_records, key, want, what):
    """The head-dim-512 launches tallied into the kernel phase's records under
    ``key`` must be one per VAE encode and one per decode."""
    got = sum(r.get(key, 0) for r in attn_records if r["dtype"] == "bf16" and r["shape"][4] == 512)
    if got != want:
        fail(f"{what}: {got} flash-attention launches at head dim 512, expected {want}")


def pipeline_phase(conv_records, swin_records, attn_records):
    import torch

    from instarevive_tpu_torch.pipelines.restore import tile_grid
    from instarevive_tpu_torch.tools.time_restore import build_v1, wall

    t0 = time.time()
    v1 = build_v1(REPO)
    torch.cuda.synchronize()
    print(f"[pipeline] built instarevive_v1 in bf16 with seeded random weights in {time.time() - t0:.1f}s", flush=True)
    b, size = v1.batch, v1.size

    out = tally_shapes(v1.process, "process", conv_records, swin_records, "launches_process", attn_records)
    launches = check_counts("process", v1.pipe, 1, 1, 1)
    check_d512(attn_records, "launches_process", 2, "process")  # the mid block of one encode, one decode
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
    out1 = tally_shapes(v1.process_tiled, "process_tiled", conv_records, swin_records, "launches_tiled", attn_records)
    # SwinIR and one encode on the whole image, a DiT forward per 4 tiles, a decode per tile
    tiled_launches = check_counts("process_tiled", v1.pipe, -(-n_tiles // 4), 1, n_tiles)
    check_d512(attn_records, "launches_tiled", 1 + n_tiles, "process_tiled")
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


def cli_phase(work):
    """The restoration CLI on two seeded PNGs under ``work/in``, writing
    ``work/out`` (which phase 16 scores)."""
    import numpy as np
    from PIL import Image

    from instarevive_tpu_torch import inference

    src, dst = os.path.join(work, "in"), os.path.join(work, "out")
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


def serve_phase(cfg_full, swin_records, process_launches, conv_records):
    """The port's server in this process, through the pieces its ``main`` puts
    together. Full width in bf16: concurrent requests in two shape buckets,
    every answer checked, ``/healthz`` held to the requests sent. Then a
    depth-cut f32 server, one answer held against ``process`` called directly
    on the same prepared image. Between them, the demo's restorer
    (``interface.build_restorer``) on one image. ``process_launches`` is what
    one ``process`` call of the full model launches; the f32 server's fused
    convolutions are tallied by shape against ``conv_records``."""
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
        got = tally_shapes(lambda: post(url, pngs[-1]), "serve, depth-cut f32", conv_records, None, "launches_serve",
                           conv_dtype="f32")
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


def train_phase(cfg_full, conv_records):
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
        timing["remat_dots"] = dots_steps(config, data, os.path.join(tmp, "dots"), extra, per_step, timing, finite,
                                          free)

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

        err = train_step_card_against_cpu(cfg_full, data, null, conv_records)
    return counts, per_step, dict(timing, three_steps_s=seconds, peak_allocated_first_run_gib=peak, card_vs_cpu=err)


def dots_steps(config, data, out, extra, per_step, full_timing, finite, free):
    """``--remat_policy dots`` (a checkpointed block keeps its Linears'
    outputs and recomputes the rest) through the launcher: one step with
    every kernel's launches as under ``full`` (the attention kernels run again
    in the recompute all the same), then warm steps timed beside ``full``'s.
    Then one step of a task built under each policy from the same seed on
    the same batch: the trained parameters of both models bit for bit equal.
    (The launcher's own runs cannot be compared so: its loader's threads
    share one generator for the crops, so two runs may crop differently.)
    Returns the record."""
    import torch

    from instarevive_tpu_torch.config import load_config
    from instarevive_tpu_torch.tools import time_train as T
    from instarevive_tpu_torch.train import launcher

    reset_counts()
    run = launcher.main(T.train_argv(config, data, out, 1, extra + ["--remat_policy", "dots"]))
    counts = read_counts()
    finite(run, "train --remat_policy dots")
    want = dict(per_step, filter2d=run.task.degrade.filter_calls)
    if run.task.gen.remat_policy != "dots" or counts != want:
        fail(f"train --remat_policy dots: policy {run.task.gen.remat_policy}, launches of a step {counts}, expected {want}")
    timing = T.time_steps(run.task, T.load_batches(data, 3))
    if timing["launches_per_step"] != T.expected_launches(len(run.task.gen.blocks)):
        fail(f"train --remat_policy dots: timed steps launched {timing['launches_per_step']}")
    del run
    shutil.rmtree(out)  # its checkpoint: as large as the full run's
    free()

    batch = T.load_batches(data, 1)[0]
    trained = {}
    for policy in ("full", "dots"):
        args = launcher.parse_args(T.train_argv(config, data, out, 1, extra + ["--remat_policy", policy]))
        task = launcher.DMDTask(args, load_config(config), torch.device("cuda"))
        task.run_step(batch)
        trained[policy] = [p.detach().cpu() for m in (task.gen, task.fake) for p in m.parameters()]
        del task
        free()
    differ = sum(not torch.equal(a, b) for a, b in zip(trained["dots"], trained["full"]))
    if differ:
        fail(f"train --remat_policy dots: after one step {differ} of {len(trained['full'])} parameter tensors differ "
             "from full's")
    print(f"[train] {card_line()}: --remat_policy dots: launches per step as under full (K1 "
          f"{per_step['flash_attn_fwd']}, K2 {per_step['flash_attn_bwd_dq']} + {per_step['flash_attn_bwd_dkv']}); one "
          f"step from the same seed and batch leaves all {len(trained['full'])} parameter tensors of both models bit "
          f"for bit full's; warm s/step {timing['step_median_s']:.4f} (steps "
          f"{', '.join(f'{t:.4f}' for t in timing['step_s'])}) against full's {full_timing['step_median_s']:.4f}; peak "
          f"allocated over the timed steps {timing['peak_allocated_gib']:.2f} GiB against full's "
          f"{full_timing['peak_allocated_gib']:.2f}", flush=True)
    return dict(timing, launches_per_step={k: v for k, v in per_step.items() if v},
                one_step_bitwise_equal_to_full=True)


def train_step_card_against_cpu(cfg_full, data, null, conv_records):
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
        step = lambda: task._step(*task.states, to(batch), None, {"y": y.to(task.device)}, draws=to(draws),  # noqa: E731
                                  keep_grads=kept)
        if label == "cuda":  # the f32 form's shapes, had the step any (it is handed latents: none)
            metrics = tally_shapes(step, "train step f32", conv_records, None, conv_dtype="f32")
        else:
            reset_counts()
            metrics = step()
        out[label] = ({k: float(v) for k, v in metrics.items()}, {k: [g.cpu() for g in v] for k, v in kept.items()})
    got = {k: v for k, v in read_counts().items() if k in T.expected_launches(2)}
    if got != T.expected_launches(2, encodes=0):
        fail(f"train step, card against CPU: launches {got}")
    launches = f32_launches(got["flash_attn_fwd"], 0, "train step, card against CPU")  # the DiT's, all at 72
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
    return dict(errs, f32_launches=launches)


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


def swinir_train_phase(cfg_full, swin_records, filter_records, work):
    """The trainer with ``--task swinir`` through its entry point at the full
    v1 SwinIR width (embed 180, 8 x 6 blocks) in bf16 from f32 masters, batch
    2 at 512x512: 3 steps, then 1 more from the checkpoint under
    ``--trace_steps 1 --trace_at 3`` (the trace is copied to
    ``work/trace.json`` for phase 16 to read); K4 once a block,
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
        again = launcher.main(T.train_argv(config, data, out, 4, ["--resume", os.path.join(out, "final"),
                                                                  "--trace_steps", "1", "--trace_at", "3"], task="swinir"))
        shutil.copy(os.path.join(out, "trace", "trace.json"), os.path.join(work, "trace.json"))
        finite(again, "train swinir, resumed")
        if (again.start_step, again.end_step, len(again.history)) != (3, 4, 1) \
                or read_counts() != dict(per_step, filter2d=again.task.degrade.filter_calls) \
                or again.task.states[0].step != 4 or again.task.states[0].opt_state["inner"]["count"] != 4:
            fail(f"train swinir, resumed: ran steps {again.start_step}..{again.end_step}, launches {read_counts()}")
        print(f"[train swinir] resumed from 'final' at step 3, took 1 step with the same launches under "
              f"--trace_steps 1 --trace_at 3: {again.history[-1]}", flush=True)

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
        f32_counts = read_counts()
        if f32_counts != small:
            fail(f"train swinir step, card against CPU: launches {read_counts()}, expected {small}")
        (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res["cuda"]
        top = max(g.abs().max().item() for g in g_cpu)
        errs = {"loss": abs(l_gpu - l_cpu) / l_cpu, "grad": max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu)) / top}
        print(f"[train swinir] one f32 step at depth 2x2, full width, card against CPU (same weights, loader batch and "
              f"handed-in draws, each device degrading for itself): loss on the CPU {l_cpu:.6f}; relative differences "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (bound {SWINIR_TRAIN_F32_BOUND:.0e})", flush=True)
        if not max(errs.values()) <= SWINIR_TRAIN_F32_BOUND:
            fail(f"train swinir step: the card differs from the CPU by {errs}")
    return counts, per_step, dict(timing, three_steps_s=seconds, card_vs_cpu=dict(errs, f32_launches=f32_counts))


def d64_phase():
    """K1 (without and with the log-sum-exp) and K2 (dq, dk/dv) at head dim
    64 at every UNet / ControlNet shape, bf16 and f32 (``head_dim_phase``).
    Returns (forward records, dq records, dk/dv records, the bf16 shapes held
    as (B, H, Nq, Nk, 64, masked))."""
    from instarevive_tpu_torch.tools.time_flash_bwd import D64_CASES

    return head_dim_phase(64, D64_CASES, ("bf16", "f32"), "bf16", seed=64)


def d32_phase():
    """K1's and K2's f32 forms at head dim 32 at the toy training-validation
    tool's shapes (``time_flash_bwd.D32_CASES``; ``head_dim_phase``). Returns
    (forward records, dq records, dk/dv records, the f32 shapes held as (B,
    H, Nq, Nk, 32, masked))."""
    from instarevive_tpu_torch.tools.time_flash_bwd import D32_CASES

    return head_dim_phase(32, D32_CASES, ("f32",), "f32", seed=32)


def head_dim_phase(d, cases, dtypes, held_dtype, seed):
    """K1 (without and with the log-sum-exp) and K2 (dq, dk/dv) at head dim
    ``d`` against ``sdpa``, ``flash_lse_plain`` and ``flash_backward_plain``
    at ``cases``, in ``dtypes``: every output relative to its largest
    magnitude (BACKWARD_BOUNDS, as at head dim 72; q, k, dO randn and v in
    [-1, 1]), the log-sum-exp to LSE_BOUNDS, the same bits twice. The
    yardsticks are ``F.scaled_dot_product_attention``: the forward alone, and
    the forward plus the backward through autograd. Returns (forward records,
    dq records, dk/dv records, the ``held_dtype`` shapes held as (B, H, Nq,
    Nk, d, masked))."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import attention as A

    fwd_records, dq_records, dkv_records, held = [], [], [], set()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tag = f"d{d}"
    for name, (b, h, nq, nk), kept in cases:
        for dt in dtypes:
            dtype = getattr(torch, DTYPES[dt])
            q = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(b, h, nk, d, device="cuda", generator=gen).to(dtype)
            v = (torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1).to(dtype)
            do = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtype)
            mask = None
            if kept is not None:
                mask = torch.arange(nk, device="cuda")[None] < torch.tensor(kept, device="cuda")[:, None]
            scale = d**-0.5
            iters = 20
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
                        fail(f"head dim {d} {name} {dt}: {key} is not finite")
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
            es, split = q.element_size(), split_form(dt)
            b_fwd = bound(es * (2 * q.numel() + 2 * k.numel()), 4.0 * pairs * d, dt, split)
            b_lse = bound(es * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel(), 4.0 * pairs * d, dt, split)
            b_dq = bound(es * (3 * q.numel() + 2 * k.numel()) + 8 * lse.numel(), 6.0 * pairs * d, dt, split)
            b_dkv = bound(es * (2 * q.numel() + 4 * k.numel()) + 8 * lse.numel(), 8.0 * pairs * d, dt, split)
            b_both = bound(es * (4 * q.numel() + 4 * k.numel()), 10.0 * pairs * d, dt, split)
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
            print(f"[{tag}] {name:18s} {dt:4s} B,H,Nq,Nk={b},{h},{nq},{nk} mask={mask is not None!s:5s} "
                  f"out rel_err={o_rel:.2e} lse={lse_err:.2e} dq={rel['dq']:.2e} dk={rel['dk']:.2e} dv={rel['dv']:.2e} "
                  f"(bounds {bnd:.0e} of each output's largest magnitude, lse {LSE_BOUNDS[dt]:.0e}) same bits "
                  f"twice={same and same_out} | ms fwd={ms_fwd:.4f} with_lse={ms_lse:.4f} (bound {b_fwd[0]:.4f}, "
                  f"{b_fwd[1]}) dq={ms_dq:.4f} dkv={ms_dkv:.4f} dq+dkv+di={ms_both:.4f} (bound {b_both[0]:.4f}) | "
                  f"plain fwd={plain_fwd_ms:.4f} bwd={plain_bwd_ms:.4f} | torch sdpa fwd={lib_fwd_ms:.4f} "
                  f"bwd={lib_bwd_ms:.4f} fwd+bwd={lib_fwd_bwd_ms:.4f}", flush=True)
            if not (o_rel <= bnd and max(rel.values()) <= bnd and lse_err <= LSE_BOUNDS[dt]):
                fail(f"head dim {d} {name} {dt}: output {o_rel}, lse {lse_err}, gradients {rel} over the bounds")
            if not (same and same_out):
                fail(f"head dim {d} {name} {dt}: two runs on the same inputs differ")
            if dt == held_dtype:
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


def cldm_phase(held64, conv_records):
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

        err = cldm_step_card_against_cpu(cfg, merge, conv_records)
    return counts, per_step, dict(timing, three_steps_s=seconds, peak_allocated_first_run_gib=peak, card_vs_cpu=err,
                                  attention_by_head_dim_3_steps=by_dim), by_dim


def cldm_step_card_against_cpu(cfg_full, merge, conv_records):
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
        step = lambda: task.train_step({k: v.to(task.device) for k, v in pair.items()}, keep_grads=kept,  # noqa: E731
                                       draws={k: v.to(task.device) for k, v in draws.items()})
        if label == "cuda":  # get_input's VAE encodes: K3's f32 form, every shape held in the kernel phase
            metrics = tally_shapes(step, "cldm step f32", conv_records, None, "launches_cldm_step", conv_dtype="f32")
        else:
            reset_counts()
            metrics = step()
        res[label] = (float(metrics["loss"]), [g.cpu() for g in kept])
    counts = read_counts()
    want = T.cldm_attention_counts(cfg)
    if (counts["flash_attn_fwd"], counts["flash_attn_bwd_dq"], counts["flash_attn_bwd_dkv"]) != \
            (want["flash_attn_fwd"], want["flash_attn_bwd_dq"], want["flash_attn_bwd_dkv"]):
        fail(f"cldm step, card against CPU: attention launches {counts}, expected {want}")
    levels, blocks = len(cfg["vae"]["ch_mult"]), cfg["vae"]["num_res_blocks"]
    modules = 2 * (levels * blocks + 2)  # the encoder's K3 convs, each packing its weight planes on its first call
    launches = f32_launches(want["d64"], want["d512"], "cldm step, card against CPU",
                            convs=want["d512"] * modules, conv_modules=modules)  # one encode per mid-block attention
    reset_counts()  # get_input again: the frozen VAE's cached planes serve every conv, no prepass
    with torch.no_grad():
        gpu.task.get_input({k: v.to(gpu.device) for k, v in pair.items()})
    torch.cuda.synchronize()
    again = read_counts()["gn_silu_conv3x3"], conv_weight_planes()
    if again != (want["d512"] * modules, 0):
        fail(f"cldm step, card against CPU: get_input after the step made {again[0]} K3 launches and packed "
             f"{again[1]} conv weights, expected {want['d512'] * modules} and 0")
    print(f"[train cldm] f32 step on the card: {launches['tf32_planes_conv_weights']} conv weights packed (one per "
          f"encoder K3 conv); get_input again: {again[0]} K3 launches, {again[1]} packed", flush=True)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res["cuda"]
    top = max(g.abs().max().item() for g in g_cpu)
    errs = {"loss": abs(l_gpu - l_cpu) / l_cpu, "grad": max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu)) / top}
    print(f"[train cldm] one f32 step, UNet and ControlNet at {CLDM_SMALL_NET} (head dim 64), VAE and SwinIR at full "
          f"width, every layer random, card against CPU (same weights, pair and draws): loss on the CPU {l_cpu:.6f}; "
          f"relative differences " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {CLDM_F32_BOUND:.0e}); attention launches on the card {want}", flush=True)
    if not max(errs.values()) <= CLDM_F32_BOUND:
        fail(f"cldm step: the card differs from the CPU by {errs}")
    return dict(errs, f32_launches=launches,
                get_input_again={"gn_silu_conv3x3_f32": again[0], "tf32_planes_conv_weights": again[1]})


# The depth-cut f32 sampling runs, card against CPU: each latent relative to
# the CPU's largest magnitude (random weights under guidance take latents to
# tens); matmuls and the attention kernels sum in other orders than the CPU.
SAMPLE_F32_BOUND = 1e-3
SAMPLE_ALGOS = ("dpm-solver", "ddim", "sa-solver", "iddpm")
SAMPLE_STEPS = 20  # every sampler here takes one model call a step (iddpm over 20 respaced steps)
CONTROL_DEPTH = 13


def random_projections(dit, seed):
    """The ControlNet-Half projections of ``dit`` drawn N(0, 0.02^2) in
    place, so that the branch moves the output (they start at zero)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in dit.named_parameters():
            if name.startswith("controlnet.") and "_proj." in name:
                t.copy_(0.02 * torch.randn(t.shape, generator=gen))


def depth_cut_f32(cfg_full, control_depth=0):
    """(CPU, card) pipelines holding only a full-width DiT cut to depth 2 (with
    ``control_depth`` ControlNet-Half stages and random projections), f32, the
    same seeded weights on both."""
    from instarevive_tpu_torch.config import merge
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params

    cfg = merge(cfg_full, {"dit": {"depth": 2}})
    cpu = init_params(build_pipeline(cfg, device="cpu", components=("dit",), control_depth=control_depth), seed=2)
    random_projections(cpu.dit, 3)
    gpu = build_pipeline(cfg, device="cuda", components=("dit",), control_depth=control_depth)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def sample_phase(cfg_full, pipe, conv_records, attn_records):
    """``instarevive_tpu_torch.sample``'s function at full v1 width in bf16:
    two prompts (the null embedding, guidance 4.5, so the DiT runs at batch 4)
    at 512x512 with each sampler for 20 steps. Each call: images of the right
    shape, finite, in [0, 1]; every kernel launched as 20 DiT calls and one
    decode imply, every K1 and K3 shape one the kernel phases held; then
    timed. One call of each under the sync debug mode ``error``: the loops
    read nothing back. Then a depth-cut f32 copy (4 DPM-Solver steps, one
    prompt) on the card against the CPU. Returns (the 20-step DPM-Solver call's launches,
    timing records)."""
    import torch

    from instarevive_tpu_torch import sample as S
    from instarevive_tpu_torch.tools.time_restore import wall

    null = pipe.dit.y_embedder.y_embedding[:300][None].float()
    y = null.expand(2, -1, -1)
    shape = S.latent_shape(["a photo", "a red panda"], 512)
    counts, timing = {}, {}
    for algo in SAMPLE_ALGOS:
        kw = dict(algo=algo, step=SAMPLE_STEPS, cfg_scale=4.5)

        def call(latents=False):
            gen = torch.Generator(device="cuda").manual_seed(0)
            return (S.sample_latents if latents else S.sample_images)(pipe, y, y, shape, generator=gen, **kw)

        t = time.perf_counter()
        imgs = tally_shapes(call, f"sample {algo}", conv_records, None, "launches_sample", attn_records,
                            attn_dims=(72, 512))
        first = time.perf_counter() - t
        check_image(imgs, (2, 512, 512, 3), f"sample {algo}")
        counts[algo] = check_counts(f"sample {algo}", pipe, SAMPLE_STEPS, 0, 1, cleans=0)
        if not torch.equal(call(), imgs):
            fail(f"sample {algo}: the same seed gave other bits")
        torch.cuda.reset_peak_memory_stats()
        walls = wall(call, 2)
        latent_walls = wall(lambda: call(latents=True), 2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        timing[algo] = dict(first_call_s=first, wall_s=walls, latents_wall_s=latent_walls,
                            ms_per_step=min(latent_walls) / SAMPLE_STEPS * 1e3, peak_gib=peak,
                            flash_attn_fwd=counts[algo]["flash_attn_fwd"])
        print(f"[sample] {card_line()}: {algo} x {SAMPLE_STEPS} steps, 2 prompts at 512x512 (DiT batch 4 under "
              f"guidance 4.5): images (2, 512, 512, 3) finite in [0, 1], the same bits twice; K1 launches "
              f"{counts[algo]['flash_attn_fwd']} = {SAMPLE_STEPS} x 2 x {pipe.dit.depth} + 1 (the decode), every "
              f"kernel as the configuration implies; wall a call {min(walls):.4f} s (runs "
              f"{', '.join(f'{w:.4f}' for w in walls)}; first {first:.2f} s), sampling alone "
              f"{timing[algo]['ms_per_step']:.2f} ms a step, peak allocated {peak:.2f} GiB", flush=True)

    # every sampler's loop waits for the card nowhere: one call of each under the sync debug mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for algo in SAMPLE_ALGOS:
            S.sample_latents(pipe, y, y, shape, generator=torch.Generator(device="cuda").manual_seed(1), algo=algo,
                             step=SAMPLE_STEPS, cfg_scale=4.5)
    except RuntimeError:
        import traceback

        fail(f"sample: a sampler synchronised with the card:\n{traceback.format_exc()}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[sample] one {SAMPLE_STEPS}-step call of each sampler under torch.cuda.set_sync_debug_mode('error'): no "
          "synchronising call", flush=True)

    # depth-cut f32: 4 DPM-Solver steps of one prompt (DiT batch 2), card against CPU
    cpu, gpu = depth_cut_f32(cfg_full)
    z0 = torch.randn(1, 64, 64, 4, generator=torch.Generator().manual_seed(4))
    cnull = cpu.dit.y_embedder.y_embedding[:300][None]
    gnull = cnull.cuda()
    kw = dict(algo="dpm-solver", step=4, cfg_scale=4.5)
    got = tally_shapes(lambda: S.sample_latents(gpu, gnull, gnull, tuple(z0.shape), x_init=z0.cuda(), **kw),
                       "sample depth-cut f32", None, None, attn_records=attn_records, conv_dtype="f32",
                       attn_dims=(72,))
    k1 = read_counts()["flash_attn_fwd"]
    ref = S.sample_latents(cpu, cnull, cnull, tuple(z0.shape), x_init=z0, **kw)
    err = (got.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    print(f"[sample] depth-cut f32 (DiT depth 2 at full width, 4 DPM-Solver steps, one prompt): card against CPU "
          f"max error {err:.3e} of max|CPU| {ref.abs().max().item():.3e} (bound {SAMPLE_F32_BOUND:.0e}); K1 "
          f"launches {k1} (4 x 2 x 2)", flush=True)
    if not err <= SAMPLE_F32_BOUND or k1 != 4 * 2 * 2:
        fail(f"sample depth-cut f32: card against CPU {err} (bound {SAMPLE_F32_BOUND}), K1 launches {k1}")
    timing["f32_card_vs_cpu"] = dict(max_rel_err=err, bound=SAMPLE_F32_BOUND, flash_attn_fwd_f32=k1)
    del cpu, gpu
    return counts["dpm-solver"], timing


def validate_phase(cfg_full, pipe, conv_records, swin_records, attn_records, filter_records):
    """``instarevive_tpu_torch.validate``'s batch function at full v1 width in
    bf16: two seeded 512x512 PNGs, read as the CLI reads them, degraded on the
    card, cleaned, encoded, 20 DPM-Solver steps with 13 ControlNet-Half stages,
    decoded; PSNR and SSIM finite. Every kernel launched as that implies (K1
    20 x 2 x (28 + 13) + the encode's + the decode's; K4 48; K6 2 or 3 as the
    draws say), every K1, K3, K4 and K6 shape held in the kernel phases; then
    timed. Then one depth-cut f32 control step (2 DPM-Solver steps with one
    stage) on the card against the CPU. Returns (the batch's launches, timing
    record)."""
    import numpy as np
    import torch
    from PIL import Image

    from instarevive_tpu_torch import validate as V
    from instarevive_tpu_torch.data import realesrgan
    from instarevive_tpu_torch.data.dataset import ImageFolderDataset, PrefetchLoader
    from instarevive_tpu_torch.ops.degradation import make_generators
    from instarevive_tpu_torch.tools.time_restore import wall

    y = pipe.dit.y_embedder.y_embedding[:300][None].float()
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(5)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (560, 600, 3), dtype=np.uint8)).save(os.path.join(tmp, f"{i}.png"))
        ds = ImageFolderDataset(tmp, out_size=512, crop_type="center", use_hflip=False)
        batch = next(iter(PrefetchLoader(ds, 2, shuffle=False, drop_last=False)))
    hq01 = torch.from_numpy(batch["hq"]).cuda().float() / 255.0
    cfg = realesrgan.RealESRGANDegradationConfig()

    def call():
        gens = make_generators(231, "cuda")
        draws = realesrgan.draw_degradation(gens.host, cfg, 2)
        return V.validate_batch(pipe, y, hq01, gens, cfg, SAMPLE_STEPS, draws=draws), draws

    t = time.perf_counter()
    out, draws = tally_shapes(call, "validate", conv_records, swin_records, "launches_validate", attn_records,
                              attn_dims=(72, 512), filter_records=filter_records)
    first = time.perf_counter() - t
    for key in ("lq", "pred", "hq"):
        check_image(out[key], (2, 512, 512, 3), f"validate {key}")
    got, want = read_counts(), expected_counts(pipe, SAMPLE_STEPS, 1, 1, 1, control_depth=CONTROL_DEPTH)
    want["filter2d"] = 2 + int(draws.blur2)
    if got != want:
        fail(f"validate: kernel launches {got}, expected {want}")
    metrics = {k: out[k].tolist() for k in ("psnr", "ssim")}
    if not all(np.isfinite(v) for vals in metrics.values() for v in vals):
        fail(f"validate: metrics not finite {metrics}")
    torch.cuda.reset_peak_memory_stats()
    walls = wall(call, 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    timing = dict(first_call_s=first, wall_s=walls, peak_gib=peak, psnr=metrics["psnr"], ssim=metrics["ssim"],
                  flash_attn_fwd=got["flash_attn_fwd"])
    print(f"[validate] {card_line()}: one batch of 2 seeded 512x512 PNGs, {SAMPLE_STEPS} DPM-Solver steps with "
          f"{CONTROL_DEPTH} ControlNet-Half stages: outputs (2, 512, 512, 3) finite in [0, 1], PSNR {metrics['psnr']} "
          f"SSIM {metrics['ssim']}; K1 launches {got['flash_attn_fwd']} = {SAMPLE_STEPS} x 2 x ({pipe.dit.depth} + "
          f"{CONTROL_DEPTH}) + 2, K4 {got['swin_window_attention']}, K6 {got['filter2d']} (second blur drawn: "
          f"{bool(draws.blur2)}), every kernel as the configuration implies; wall a batch {min(walls):.4f} s (runs "
          f"{', '.join(f'{w:.4f}' for w in walls)}; first {first:.2f} s), peak allocated {peak:.2f} GiB", flush=True)

    # one depth-cut f32 control step: 2 DPM-Solver steps with one stage, card against CPU
    cpu, gpu = depth_cut_f32(cfg_full, control_depth=1)
    gen = torch.Generator().manual_seed(6)
    c, z0 = torch.randn(2, 64, 64, 4, generator=gen), torch.randn(2, 64, 64, 4, generator=gen)
    cy = cpu.dit.y_embedder.y_embedding[:300][None]
    gz = tally_shapes(lambda: V.control_sample(gpu, cy.cuda(), c.cuda(), z0.cuda(), 2), "validate depth-cut f32",
                      None, None, attn_records=attn_records, conv_dtype="f32", attn_dims=(72,))
    k1 = read_counts()["flash_attn_fwd"]
    ref = V.control_sample(cpu, cy, c, z0, 2)
    err = (gz.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    print(f"[validate] depth-cut f32 control step (DiT depth 2 + 1 ControlNet-Half stage at full width, random "
          f"projections, 2 DPM-Solver steps, batch 2): card against CPU max error {err:.3e} of max|CPU| "
          f"{ref.abs().max().item():.3e} (bound {SAMPLE_F32_BOUND:.0e}); K1 launches {k1} (2 x 2 x 3)", flush=True)
    if not err <= SAMPLE_F32_BOUND or k1 != 2 * 2 * 3:
        fail(f"validate depth-cut f32: card against CPU {err} (bound {SAMPLE_F32_BOUND}), K1 launches {k1}")
    timing["f32_card_vs_cpu"] = dict(max_rel_err=err, bound=SAMPLE_F32_BOUND, flash_attn_fwd_f32=k1)
    return got, timing


# The 2K sampling phase: configs/pixart_kv2k.yaml through the sampling CLI's
# functions, two prompts at 2048x2048, 10 DPM-Solver++(2M) steps (cut from 20
# to make room for phase 20: the call's four runs took 45 s of the script;
# the 20-step call is timed by tools/time_sample.py). Its depth-cut f32 DiT
# with every option, card against CPU, is held as the depth-cut sampling runs
# are.
SAMPLE_2K_STEPS = 10
OPTIONS_F32_BOUND = 1e-3


def sample_2k_phase(conv_records, attn_records):
    """``instarevive_tpu_torch.sample`` at ``--config configs/pixart_kv2k.yaml
    --image_size 2048``: the pipeline as ``inference.load_pipeline`` builds
    it (bf16, seeded random weights), two prompts (the null embedding,
    guidance 4.5: the DiT at batch 4 on a 128 x 128 token grid, blocks 0-13
    over K and V compressed 2x a side by the depthwise conv), SAMPLE_2K_STEPS
    steps of DPM-Solver++(2M), the decode at 2048x2048. Images checked; every
    kernel launched as that many DiT calls and one decode imply, K1 by shape (at 16,384
    keys, 4,096 keys and the 300 caption keys, one at head dim 512), every K1
    and K3 shape one the kernel phases held; wall a call, ms a step, peak
    memory. Then ``options_card_against_cpu``. Returns (the call's launches,
    timing record)."""
    import torch

    from instarevive_tpu_torch import sample as S
    from instarevive_tpu_torch.inference import load_pipeline
    from instarevive_tpu_torch.tools.time_restore import wall

    prompts = ["a photo", "a red panda"]
    args = S.parse_args(["--config", os.path.join(REPO, "configs", "pixart_kv2k.yaml"), "--image_size", "2048",
                         "--random_init", "--step", str(SAMPLE_2K_STEPS), "--prompt", *prompts])
    pipe, null = load_pipeline(args)
    y = null.expand(len(prompts), -1, -1)
    shape = S.latent_shape(args.prompt, args.image_size, pipe.latent_factor)

    def call(latents=False):
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        return (S.sample_latents if latents else S.sample_images)(
            pipe, y, y, shape, algo=args.sampling_algo, step=args.step, cfg_scale=args.cfg_scale, generator=gen)

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    imgs = tally_shapes(call, "sample 2K", conv_records, None, "launches_sample_2k", attn_records, attn_dims=(72, 512))
    first = time.perf_counter() - t
    check_image(imgs, (2, 2048, 2048, 3), "sample 2K")
    if imgs.std().item() < 1e-3:
        fail("sample 2K: the images are flat")
    counts = check_counts("sample 2K", pipe, SAMPLE_2K_STEPS, 0, 1, cleans=0)
    by_name = {r["name"]: r.get("launches_sample_2k", 0) for r in attn_records if r["dtype"] == "bf16"}
    blocks = pipe.dit.depth
    compressed = sum(blk.attn.sampling is not None for blk in pipe.dit.blocks)
    want = {"dit2k_self": SAMPLE_2K_STEPS * (blocks - compressed),
            "dit2k_self_kv_compressed": SAMPLE_2K_STEPS * compressed,
            "dit2k_cross": SAMPLE_2K_STEPS * blocks, "vae_mid_2k_b2": 1}
    got = {name: by_name[name] for name in want}
    if got != want or sum(by_name.values()) != counts["flash_attn_fwd"] or compressed != 14:
        fail(f"sample 2K: K1 launches by shape {got}, expected {want} ({counts['flash_attn_fwd']} in all)")
    del imgs
    walls = wall(call, 2)
    latent_walls = wall(lambda: call(latents=True), 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    timing = dict(first_call_s=first, wall_s=walls, latents_wall_s=latent_walls,
                  ms_per_step=min(latent_walls) / SAMPLE_2K_STEPS * 1e3, peak_gib=peak, k1_by_shape=got,
                  flash_attn_fwd=counts["flash_attn_fwd"])
    print(f"[sample 2K] {card_line()}: configs/pixart_kv2k.yaml, dpm-solver x {SAMPLE_2K_STEPS} steps, 2 prompts at "
          f"2048x2048 (DiT batch 4 under guidance 4.5, 16,384 tokens an image): images (2, 2048, 2048, 3) finite in "
          f"[0, 1]; K1 launches {counts['flash_attn_fwd']} = {SAMPLE_2K_STEPS} x 2 x {blocks} + 1, by shape {got}, "
          f"every kernel as the configuration implies; wall a call {min(walls):.4f} s (runs "
          f"{', '.join(f'{w:.4f}' for w in walls)}; first {first:.2f} s), sampling alone {timing['ms_per_step']:.2f} ms "
          f"a step, peak allocated {peak:.2f} GiB", flush=True)
    del pipe, null, y
    torch.cuda.empty_cache()
    timing["options_f32_card_vs_cpu"] = options_card_against_cpu(args.config, attn_records)
    return counts, timing


def options_card_against_cpu(config, attn_records):
    """A DiT at full width cut to depth 2 with every option of the JAX
    package on, f32, the same seeded weights (norms drawn off (1, 0)) on the
    card and the CPU: block 0 over K and V compressed 2x a side (``conv``,
    ``uniform`` and ``ave`` in turn), block 1 in 8-token windows over a 12 x 20
    token grid (padded to 16 x 24), qk-norm in both, micro-conditioning with
    the latent's sizes and with ``data_info``. Each output within
    OPTIONS_F32_BOUND of the CPU's largest magnitude, 4 K1 launches a
    forward, every K1 shape one the kernel phase held in f32."""
    import torch

    from instarevive_tpu_torch.config import load_config, merge
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params

    gen = torch.Generator().manual_seed(8)
    z = torch.randn(2, 24, 40, 4, generator=gen)
    t = torch.tensor([999.0, 250.0])
    y = torch.randn(2, 300, 4096, generator=gen) * 4096**-0.5
    info = {"img_hw": torch.tensor([[192.0, 320.0], [1024.0, 2048.0]]), "aspect_ratio": torch.tensor([[0.6], [0.5]])}
    errs = {}
    for sampling in ("conv", "uniform", "ave"):
        cfg = merge(load_config(config), {"dit": dict(
            depth=2, kv_compress_sampling=sampling, kv_compress_ratio=2, kv_compress_layers=[0], qk_norm=True,
            window_size=8, window_block_indexes=[1], micro_condition=True)})
        cpu = init_params(build_pipeline(cfg, device="cpu", components=("dit",)), seed=9).dit
        with torch.no_grad():
            for name, p in cpu.named_parameters():
                if "norm" in name:
                    p.add_(0.2 * torch.randn(p.shape, generator=gen))
        gpu = build_pipeline(cfg, device="cuda", components=("dit",)).dit
        gpu.load_state_dict(cpu.state_dict())
        for label, data_info in (("latent sizes", None), ("data_info", info)):
            with torch.inference_mode():
                ref = cpu(z, t, y, data_info=data_info)
                got = tally_shapes(lambda: gpu(z.cuda(), t.cuda(), y.cuda(), data_info=data_info),
                                   f"options f32 {sampling}, {label}", None, None, attn_records=attn_records,
                                   conv_dtype="f32", attn_dims=(72,))
            k1 = read_counts()["flash_attn_fwd"]
            err = (got.cpu() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            errs[f"{sampling}, {label}"] = err
            if not err <= OPTIONS_F32_BOUND or k1 != 4 or not torch.isfinite(got).all():
                fail(f"options f32 {sampling}, {label}: card against CPU {err} (bound {OPTIONS_F32_BOUND}), K1 {k1}")
        del cpu, gpu
    print(f"[sample 2K] depth-cut f32 DiT with every option (KV compression by conv, uniform and ave; qk-norm; an "
          f"8-token window over a 12 x 20 grid; micro-conditioning), card against CPU, max error of max|CPU|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {OPTIONS_F32_BOUND:.0e}); 4 K1 launches "
          "a forward", flush=True)
    return dict(max_rel_err=errs, bound=OPTIONS_F32_BOUND)


# Phase 16, the evaluation networks: each in f32 on the card against itself
# on the CPU for one image, every output relative to its largest magnitude
# on the CPU. The CPU tests hold the port to the JAX package at the same 1e-5
# (tests/test_torch_iqa.py, test_torch_clip_rn50.py, test_torch_face.py):
# summation order only, the port in f32 being within 1.1e-6 of itself in
# float64 at these weights; TF32 is off.
EVAL_CARD_CPU_BOUND = 1e-5
# What each score can be: PSNR positive, SSIM a correlation, LPIPS, NIQE and
# MANIQA (a weighted mean of ReLU'd scores) non-negative, CLIP-IQA a
# probability; MUSIQ regresses a score and is held to finite.
EVAL_RANGES = {"psnr": (0.0, float("inf")), "ssim": (-1.0, 1.0), "lpips": (0.0, float("inf")),
               "niqe": (0.0, float("inf")), "clipiqa": (0.0, 1.0), "musiq": (-float("inf"), float("inf")),
               "maniqa": (0.0, float("inf"))}


def evaluation_phase(cfg_full, work, swin_records):
    """Phase 16: image-quality evaluation on the card. Builds LPIPS
    (AlexNet), MUSIQ, MANIQA, CLIP RN50 (with a stub tokenizer) and
    RetinaFace at their published widths from seeded official-layout state
    dicts through the port's loaders; scores phase 6's restored PNGs against
    their inputs with ``evaluate_img.evaluate`` (NIQE fitted on the inputs,
    on the host), every value finite and in its range, wall per image per
    metric, peak memory; holds each network on the card against the CPU;
    runs one RetinaFace detection and one align -> paste round trip on a
    512x512 image; one forward of the full-width v1 SwinIR with the residual
    head (``upsampler: ""``, no unshuffle) on 4x512x512, 48 K4 launches at
    a shape phase 3 held and no K5c; and reads phase 10's trace for K4's
    kernel. Returns the phase's record."""
    import numpy as np
    import torch
    from PIL import Image

    from instarevive_tpu_torch import evaluate_img
    from instarevive_tpu_torch.config import merge
    from instarevive_tpu_torch.models import clip_rn50
    from instarevive_tpu_torch.nn.layers import load_built
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params
    from instarevive_tpu_torch.tools import iqa_checkpoints as C
    from instarevive_tpu_torch.utils import face_helper, maniqa, musiq, niqe, retinaface
    from instarevive_tpu_torch.utils.clipiqa import CLIPIQA
    from instarevive_tpu_torch.utils.image_io import list_image_files
    from instarevive_tpu_torch.utils.metrics import LPIPS, lpips_state_dict

    t_phase = time.perf_counter()
    src, dst = os.path.join(work, "in"), os.path.join(work, "out")
    clip_sd = C.clip_rn50(3)
    meta = clip_rn50.clip_meta(clip_sd)
    sds = {"lpips": lpips_state_dict(*C.lpips(0)), "musiq": musiq.state_dict_from_torch(C.musiq(1)),
           "maniqa": maniqa.state_dict_from_torch(C.maniqa(2)), "clip": clip_rn50.state_dict_from_torch(clip_sd),
           "retinaface": retinaface.state_dict_from_torch(C.retinaface(4))}
    del clip_sd

    def build(name, device):
        sd = sds[name]
        if name == "musiq":
            return musiq.MUSIQ.from_state_dict(sd, device)
        if name == "clip":
            return clip_rn50.from_state_dict(sd, device, meta)
        if name == "retinaface":
            return retinaface.from_state_dict(sd, device).net
        return load_built({"lpips": LPIPS, "maniqa": maniqa.MANIQA}[name], sd, device)

    nets = {name: build(name, "cuda") for name in sds}
    params = {name: sum(p.numel() for p in net.parameters()) for name, net in nets.items()}
    build_s = time.perf_counter() - t_phase
    print(f"[evaluate] {card_line()}: built from seeded official-layout state dicts through the port's loaders in "
          f"{build_s:.1f}s: parameters {params}; CLIP RN50 {meta}", flush=True)

    # scoring: phase 6's restored PNGs against their inputs, every network on the card in f32
    pris = niqe.fit_pristine_model([np.asarray(Image.open(f).convert("L"), np.float64) for f in list_image_files(src)])
    clip = CLIPIQA(model=nets["clip"], tokenizer=C.StubTokenizer())
    metrics = {"lpips": nets["lpips"], "niqe": lambda img: niqe.niqe(img[0], pris),
               "clipiqa": lambda img: float(clip(img)[0]), "musiq": lambda img: float(nets["musiq"].score(img)[0]),
               "maniqa": lambda img: float(nets["maniqa"].score(img)[0])}
    files = list_image_files(dst)
    evaluate_img.evaluate(files[:1], metrics, "cuda", src)  # first calls (cuDNN's plans) before the timed pass
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds = {}
    results = evaluate_img.evaluate(files, metrics, "cuda", src, seconds=seconds)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(read_counts().values()):  # the networks are plain torch ops and cuDNN: no kernel of the port
        fail(f"evaluate: scoring launched the port's kernels {read_counts()}")
    for name, values in results.items():
        lo, hi = EVAL_RANGES[name]
        if len(values) != len(files) or not all(np.isfinite(v) and lo <= v <= hi for v in values):
            fail(f"evaluate: {name} gave {values} over {len(files)} images, outside [{lo}, {hi}] or not finite")
    per_image = {name: float(np.median(v)) for name, v in seconds.items()}
    for line in evaluate_img.report(results):
        print(f"[evaluate] {line}", flush=True)
    print(f"[evaluate] {[os.path.basename(f) for f in files]} against their inputs: values "
          + ", ".join(f"{k} {[round(v, 6) for v in vals]}" for k, vals in results.items())
          + "; wall s per image (median, to a synchronise): " + ", ".join(f"{k} {v:.4f}" for k, v in per_image.items())
          + f"; peak allocated {peak:.2f} GiB", flush=True)

    # each network in f32 on the card against the CPU, on one image
    img = np.asarray(Image.open(files[0]).convert("RGB"), np.float32)[None] / 255.0  # 512x512
    ref = np.asarray(Image.open(evaluate_img.find_reference(files[0], src)).convert("RGB"), np.float32)[None] / 255.0
    hh, ww = min(img.shape[1], ref.shape[1]), min(img.shape[2], ref.shape[2])
    prepped = musiq.musiq_prepare(img[0])
    ids = C.StubTokenizer()(["Good photo.", "Bad photo."])["input_ids"]

    def probe(name, net, dev):
        with torch.no_grad():
            if name == "lpips":
                a, b = (torch.from_numpy(np.ascontiguousarray(x[:, :hh, :ww])).to(dev) * 2 - 1 for x in (img, ref))
                return [net(a, b)]
            if name == "musiq":
                return [net(*(torch.from_numpy(v[None]).to(dev) for v in prepped))]
            if name == "maniqa":
                return [net(torch.from_numpy(np.ascontiguousarray(img[:, 144:368, 144:368])).to(dev))]
            if name == "clip":
                return [net.get_image_features(clip._preprocess(img).to(dev)), net.get_text_features(ids)]
            bgr = np.ascontiguousarray(img[..., ::-1]) * 255.0 - np.array([104.0, 117.0, 123.0], np.float32)
            return list(net(torch.from_numpy(bgr).to(dev)))

    errs = {}
    for name in sds:
        got = [t.float().cpu() for t in probe(name, nets[name], "cuda")]
        want = probe(name, build(name, "cpu"), "cpu")
        errs[name] = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    print("[evaluate] card against CPU in f32 (one image, same weights; each output relative to its largest "
          "magnitude on the CPU): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {EVAL_CARD_CPU_BOUND:.0e})", flush=True)
    if not max(errs.values()) <= EVAL_CARD_CPU_BOUND:
        fail(f"evaluate: a network on the card differs from the CPU by {errs}")

    # the face tools on a 512x512 image: one detection, one align -> paste round trip
    detector = retinaface.RetinaFace(nets["retinaface"])
    t = time.perf_counter()
    boxes, marks = detector(img[0], conf_thresh=0.5)
    detect_s = time.perf_counter() - t
    landmarks = marks[0] if len(marks) else face_helper.FFHQ_TEMPLATE_512 * 0.5 + 128.0
    helper = face_helper.FaceRestoreHelper(face_size=512)
    x = torch.from_numpy(img[0]).cuda()
    t = time.perf_counter()
    faces = helper.align_all(x, [landmarks])
    back = helper.paste_all(x, faces)
    torch.cuda.synchronize()
    round_trip_s = time.perf_counter() - t
    corners = torch.stack([back[0, 0], back[0, -1], back[-1, 0], back[-1, -1]])
    if faces[0].shape != (512, 512, 3) or back.shape != x.shape or not torch.isfinite(back).all() \
            or back.min().item() < 0 or back.max().item() > 1:
        fail(f"evaluate: align -> paste gave a face {tuple(faces[0].shape)}, an image {tuple(back.shape)} "
             f"in [{back.min().item()}, {back.max().item()}]")
    round_trip_err = (back - x).abs().max().item()
    print(f"[evaluate] RetinaFace on 512x512: {len(boxes)} faces over 0.5 after NMS in {detect_s:.3f}s; align -> paste "
          f"round trip of {'the first detection' if len(marks) else 'template landmarks'} in {round_trip_s:.3f}s, "
          f"max change {round_trip_err:.4f}, corners unchanged: "
          f"{torch.equal(corners, torch.stack([x[0, 0], x[0, -1], x[-1, 0], x[-1, -1]]))}", flush=True)
    del nets, clip, detector, x, back, faces
    torch.cuda.empty_cache()

    # SwinIR's residual head at full v1 width on 4x512x512 (no unshuffle: 512x512 tokens an image)
    cfg = merge(cfg_full, {"swinir": {"upsampler": "", "unshuffle": False, "sf": 1}})
    sw = init_params(build_pipeline(cfg, dtype=torch.bfloat16, device="cuda", components=("swinir",)), seed=0).swinir
    lq = torch.rand(4, 512, 512, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    t = time.perf_counter()
    with torch.no_grad():
        out = tally_shapes(lambda: sw(lq), "evaluate: residual SwinIR", None, swin_records)
    swin_s = time.perf_counter() - t
    counts = read_counts()
    want = dict(dict.fromkeys(counters(), 0), swin_window_attention=sum(cfg["swinir"]["depths"]))
    if counts != want or tuple(out.shape) != (4, 512, 512, 3) or not torch.isfinite(out).all():
        fail(f"evaluate: residual SwinIR gave {tuple(out.shape)}, launches {counts}, expected {want}")
    print(f"[evaluate] SwinIR upsampler '' at full v1 width (embed {cfg['swinir']['embed_dim']}, no unshuffle), bf16, "
          f"4x512x512: {swin_s:.3f}s (first call), launches {({k: v for k, v in counts.items() if v})}, no upsample2x",
          flush=True)
    del sw, lq, out
    torch.cuda.empty_cache()

    # phase 10's trace of the resumed SwinIR step
    with open(os.path.join(work, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k4 = sum("swin16::kernel" in e.get("name", "") for e in events)
    if not k4:
        fail(f"evaluate: the trainer's trace holds {len(events)} events, {len(kernels)} kernels, none of K4's")
    phase_s = time.perf_counter() - t_phase
    print(f"[evaluate] trainer trace (--trace_steps 1 --trace_at 3): {len(events)} events, {len(kernels)} kernel "
          f"launches, {k4} of K4's swin16::kernel; phase wall {phase_s:.1f}s", flush=True)
    return {"values": results, "s_per_image": per_image, "peak_gib": peak, "card_vs_cpu": errs,
            "card_vs_cpu_bound": EVAL_CARD_CPU_BOUND, "faces": len(boxes), "detect_s": detect_s,
            "round_trip_s": round_trip_s, "residual_swinir_s": swin_s, "residual_swinir_launches": counts,
            "trace_kernels": len(kernels), "trace_k4": k4, "build_s": build_s, "phase_s": phase_s}


# Phase 17: the text encoders and prompted sampling, the data-preparation CLIs,
# RRDBNet, MiDaS/DPT depth and the LLaVA-MPT captioner, each at the published
# width of its configuration with seeded weights built on the card, and a
# depth-cut copy at full width in f32 on the card against the CPU: f32 GEMMs
# and convolutions (TF32 off) and, in DPT, K1's split-tf32 products sum in
# other orders than the CPU over one to four layers.
AUX_CARD_CPU_BOUND = 1e-4  # of max|CPU|
AUX_DEPTH_CUTS = {"dpt_hybrid": "4 ViT blocks", "dpt_large": "4 ViT blocks", "midas_v21": "one block a stage",
                  "midas_v21_small": "full depth"}
AUX_PROMPTS = ["a photo of a red panda in the snow, high quality", "portrait of an old man with a detailed face"]


def sync_walls(call, runs=2):
    """(the last output, host seconds to a synchronise for each of ``runs``
    calls, peak GiB allocated over them)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, out = [], None
    for _ in range(runs):
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return out, walls, torch.cuda.max_memory_allocated() / 2**30


def kernel_split(what, call, top=3):
    """One more ``call`` under ``torch.profiler``: its device time by kernel
    (memory copies included), the launches, the ``top`` kernels by time;
    printed and returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0 and e.self_cpu_time_total == 0),
                     key=lambda e: -e.self_device_time_total)
    out = dict(kernel_ms=sum(e.self_device_time_total for e in kernels) / 1e3, launches=sum(e.count for e in kernels),
               top=[(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in kernels[:top]])
    print(f"[aux] {what}: {out['kernel_ms']:.2f} ms of device time in {out['launches']} launches; the most: "
          + "; ".join(f"{name} {ms:.2f} ms in {n}" for name, ms, n in out["top"]), flush=True)
    return out


def card_vs_cpu(what, cpu_model, run):
    """``run(model, device)`` on the CPU model and on a copy on the card; the
    largest difference over the largest CPU magnitude, held to
    ``AUX_CARD_CPU_BOUND``."""
    import copy

    import torch

    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    with torch.no_grad():
        ref = run(cpu_model, "cpu").float()
        got = run(gpu_model, "cuda").float().cpu()
    if ref.abs().max().item() == 0:
        fail(f"{what}: the CPU's output is all zeros, nothing to compare")
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    print(f"[aux] {what}: card against CPU in f32 max error {err:.3e} of max|CPU| {ref.abs().max().item():.3e} "
          f"(bound {AUX_CARD_CPU_BOUND:.0e})", flush=True)
    if not (torch.isfinite(got).all() and err <= AUX_CARD_CPU_BOUND):
        fail(f"{what}: card against CPU {err} > {AUX_CARD_CPU_BOUND}")
    del gpu_model
    torch.cuda.empty_cache()
    return err


def no_kernel_launched(what):
    got = read_counts()
    if any(got.values()):
        fail(f"{what}: launched kernels of the port {got}; its path has none")


def aux_phase(cfg_full, conv_records, attn_records, filter_records):
    """Phase 17 (see the module docstring). Returns its record."""
    import json as _json

    import numpy as np
    import torch
    from PIL import Image
    from transformers import CLIPTextModel, CLIPVisionModel, T5EncoderModel

    from instarevive_tpu_torch import sample as S
    from instarevive_tpu_torch.models import clip, dpt, llava_mpt, rrdbnet, t5
    from instarevive_tpu_torch.ops.degradation import make_generators
    from instarevive_tpu_torch.ops.tf32_planes import tf32_planes
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params
    from instarevive_tpu_torch.tools import extract_features, lq
    from instarevive_tpu_torch.tools import text_checkpoints as tc
    from instarevive_tpu_torch.train.ldm_tasks import LatentDiffusionTask

    t_phase = time.perf_counter()
    card, rec = card_line(), {}
    work = tempfile.mkdtemp(prefix="chip_smoke_aux_")
    atexit.register(shutil.rmtree, work, True)

    # -- T5 v1.1 XXL's encoder: 2 prompts at 300 tokens ----------------------------------------------------------
    t = time.perf_counter()
    t5_model = tc.seeded_model(lambda: T5EncoderModel(tc.t5_config()), 0, "cuda")
    build_s = time.perf_counter() - t
    t5_tok = tc.word_tokenizer(32128, 300, "t5")
    embedder = t5.T5Embedder(model=t5_model, tokenizer=t5_tok, model_max_length=300)
    reset_counts()
    (y, mask), walls, peak = sync_walls(lambda: embedder.encode(AUX_PROMPTS))
    no_kernel_launched("T5 encode")
    if tuple(y.shape) != (2, 300, 4096) or not torch.isfinite(y).all():
        fail(f"T5: embeddings {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
    params = sum(p.numel() for p in t5_model.parameters())
    print(f"[aux] {card}: T5 v1.1 XXL encoder ({params / 1e9:.3f} B parameters, f32, built on the card in "
          f"{build_s:.1f}s): 2 prompts at 300 tokens -> {tuple(y.shape)} finite, {int(mask.sum())} real tokens; "
          f"wall {walls[-1]:.4f} s (first {walls[0]:.4f}), peak allocated {peak:.2f} GiB; no kernel of the port",
          flush=True)
    ids = t5_tok(AUX_PROMPTS, max_length=300, padding="max_length", truncation=True, return_tensors="pt")
    err = card_vs_cpu("T5 encoder at depth 1",
                      tc.seeded_model(lambda: T5EncoderModel(tc.t5_config(num_layers=1)), 1, "cpu"),
                      lambda m, dev: m(input_ids=ids["input_ids"].to(dev),
                                       attention_mask=ids["attention_mask"].to(dev)).last_hidden_state)
    rec["t5"] = dict(parameters=params, build_s=build_s, wall_s=walls, peak_gib=peak, card_vs_cpu=err)

    # -- a prompted 20-step DPM-Solver++(2M) sample at 512^2, guidance 4.5 ----------------------------------------
    pipe = init_params(build_pipeline(cfg_full, dtype=torch.bfloat16, device="cuda"), seed=0)
    null = pipe.dit.y_embedder.y_embedding[:300][None].float().expand(2, -1, -1)
    shape = S.latent_shape(AUX_PROMPTS, 512)

    def prompted(y_):
        return S.sample_images(pipe, y_, null, shape, generator=torch.Generator(device="cuda").manual_seed(0),
                               algo="dpm-solver", step=SAMPLE_STEPS, cfg_scale=4.5)

    imgs = tally_shapes(lambda: prompted(y), "prompted sample", conv_records, None, None, attn_records,
                        attn_dims=(72, 512))
    check_image(imgs, (2, 512, 512, 3), "prompted sample")
    counts = {"prompted_sample": check_counts("prompted sample", pipe, SAMPLE_STEPS, 0, 1, cleans=0)}
    if torch.equal(imgs, prompted(null)):
        fail("prompted sample: the T5 prompts gave the null prompt's images")
    _, walls, peak = sync_walls(lambda: prompted(y))
    print(f"[aux] {card}: prompted sample (T5 y, the null embedding unconditional, DPM-Solver++(2M) x {SAMPLE_STEPS} "
          f"at 512x512, guidance 4.5): images (2, 512, 512, 3) finite in [0, 1], other than the null prompt's; K1 "
          f"{counts['prompted_sample']['flash_attn_fwd']} launches, every kernel as {SAMPLE_STEPS} DiT calls and a "
          f"decode imply, every shape held; wall {min(walls):.4f} s, peak allocated {peak:.2f} GiB", flush=True)
    rec["prompted_sample"] = dict(wall_s=walls, peak_gib=peak, launches=counts["prompted_sample"])
    del pipe
    torch.cuda.empty_cache()

    # -- extract_features at configs/instarevive_v1.yaml: 8 seeded 512^2 PNGs at batch 8, T5 captions -------------
    src, out = os.path.join(work, "ef_in"), os.path.join(work, "ef_out")
    os.makedirs(src)
    rng = np.random.default_rng(17)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)).save(os.path.join(src, f"{i}.png"))
    caps = os.path.join(work, "captions.json")
    with open(caps, "w") as f:
        _json.dump({f"{i}.png": AUX_PROMPTS[i % 2] for i in range(8)}, f)
    cap_embedder = t5.T5Embedder(model=t5_model, tokenizer=tc.word_tokenizer(32128, 120, "t5"), model_max_length=120)
    v1 = os.path.join(REPO, "configs", "instarevive_v1.yaml")
    argv = ["--input", src, "--output", out, "--config", v1, "--captions", caps, "--batch_size", "8",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    written = tally_shapes(lambda: extract_features.main(argv, embedder=cap_embedder), "extract_features",
                           conv_records, None, None, attn_records, conv_dtype="f32", attn_dims=(512,))
    ef_s, peak = time.perf_counter() - t, torch.cuda.max_memory_allocated() / 2**30
    counts["extract_features"] = got = read_counts()
    vae = extract_features.vae_encoder(v1, None, "cuda").vae
    convs = 2 * (len(vae.ch_mult) * len(vae.encoder.down[0].block) + 2)
    want = dict({k: 0 for k in got}, flash_attn_fwd=1, gn_silu_conv3x3=convs, gn_stats_fold=convs + 2, gn_apply=2)
    if written != {"latents": 8, "t5": 8} or got != want:
        fail(f"extract_features: wrote {written}, launches {got}, expected {want}")
    for i in range(8):
        z = np.load(os.path.join(out, "vae_feat", f"{i}.npz"))["latent"]
        f = np.load(os.path.join(out, "t5_feat", f"{i}.npz"))
        if z.shape != (64, 64, 4) or not np.isfinite(z).all() or f["caption_feature"].shape != (120, 4096) \
                or f["attention_mask"].shape != (120,):
            fail(f"extract_features: image {i}: latent {z.shape}, caption {f['caption_feature'].shape}")
    print(f"[aux] {card}: extract_features (f32 VAE encode of 8 x 512^2 at batch 8 on K3's f32 form, K5a/b and K1 "
          f"at head dim 512, every shape held; T5 captions at 120 tokens; the saver thread): 8 latents (64, 64, 4) "
          f"and 8 caption features (120, 4096) written; launches {got}; wall {ef_s:.2f} s with the VAE's build, peak "
          f"allocated {peak:.2f} GiB", flush=True)
    cpu_pipe = extract_features.vae_encoder(v1, None, "cpu")
    cpu_pipe.vae.load_state_dict(vae.state_dict())
    img = torch.from_numpy(np.asarray(Image.open(os.path.join(src, "0.png")), np.float32)[None, :256, :256] / 255.0)
    err = card_vs_cpu("extract_features' VAE encode, one 256^2 crop", cpu_pipe,
                      lambda p, dev: p.encode(img.to(dev)))
    rec["extract_features"] = dict(wall_s=ef_s, peak_gib=peak, launches=got, card_vs_cpu=err)
    del t5_model, embedder, cap_embedder, vae, cpu_pipe
    torch.cuda.empty_cache()

    # -- the OpenCLIP ViT-H/14 text tower, penultimate layer ----------------------------------------------------
    t = time.perf_counter()
    clip_model = tc.seeded_model(lambda: CLIPTextModel(tc.clip_text_config()), 2, "cuda")
    build_s = time.perf_counter() - t
    tok = tc.word_tokenizer(49408, 77, "clip")
    cond = clip.FrozenCLIPEmbedder(model=clip_model, tokenizer=tok, layer="penultimate")
    reset_counts()
    ctx, walls, peak = sync_walls(lambda: cond.encode_tensor(AUX_PROMPTS))
    no_kernel_launched("CLIP text encode")
    if tuple(ctx.shape) != (2, 77, 1024) or not torch.isfinite(ctx).all():
        fail(f"OpenCLIP text tower: context {tuple(ctx.shape)}")
    print(f"[aux] {card}: OpenCLIP ViT-H/14 text tower ({sum(p.numel() for p in clip_model.parameters()) / 1e6:.1f} M "
          f"parameters, built in {build_s:.1f}s): 2 prompts -> penultimate layer {tuple(ctx.shape)} finite; wall "
          f"{walls[-1]:.4f} s (first {walls[0]:.4f}), peak allocated {peak:.2f} GiB; no kernel of the port", flush=True)
    ids = tok(AUX_PROMPTS, max_length=77, padding="max_length", truncation=True, return_tensors="pt")
    err = card_vs_cpu("OpenCLIP text tower at depth 2, penultimate layer",
                      tc.seeded_model(lambda: CLIPTextModel(tc.clip_text_config(num_hidden_layers=2)), 3, "cpu"),
                      lambda m, dev: m(input_ids=ids["input_ids"].to(dev), attention_mask=ids["attention_mask"].to(dev),
                                       output_hidden_states=True).hidden_states[-2])
    rec["openclip_text"] = dict(wall_s=walls, peak_gib=peak, card_vs_cpu=err)
    del clip_model, cond
    torch.cuda.empty_cache()

    # -- lq on 2 seeded images -------------------------------------------------------------------------------
    src, out = os.path.join(work, "lq_in"), os.path.join(work, "lq_out")
    os.makedirs(src)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)).save(os.path.join(src, f"{i}.png"))
    t = time.perf_counter()
    paths = tally_shapes(lambda: lq.main(["--input", src, "--output", out, "--device", "cuda"]), "lq", None, None,
                         filter_records=filter_records)
    lq_s = time.perf_counter() - t
    counts["lq"] = got = read_counts()
    if got["filter2d"] != 2 or len(paths) != 2:
        fail(f"lq: filter2d launches {got['filter2d']} for 2 images, {len(paths)} written")
    for p in paths:
        a = np.asarray(Image.open(p))
        if a.shape != (512, 512, 3) or a.std() == 0:
            fail(f"lq: {p} is {a.shape}, std {a.std()}")
    print(f"[aux] {card}: lq on 2 x 512^2 (the 41^2 mixed kernel through K6, held in its phase; bilinear down and "
          f"up, noise, DiffJPEG): 2 PNGs written; filter2d launches {got['filter2d']}; wall {lq_s:.3f} s", flush=True)
    gens = make_generators(5, "cpu")
    draws = lq.draw_lq(gens)
    hq = torch.from_numpy(np.asarray(Image.open(os.path.join(src, "0.png")), np.float32)[None] / 255.0)
    draws.fields = (torch.randn(1, 170, 170, 3, generator=gens.device),
                    torch.randn(1, 170, 170, 1, generator=gens.device))
    with torch.no_grad():
        ref = lq.blur_down_noise(hq, (170, 170), draws)
        dev_draws = lq.LQDraws(kernel=draws.kernel, sigma=draws.sigma, fields=tuple(f.cuda() for f in draws.fields))
        stage = lq.blur_down_noise(hq.cuda(), (170, 170), dev_draws).cpu()
        err = (stage - ref).abs().max().item()
        lvl = (torch.round(lq.jpeg_up(stage.cuda(), (512, 512), 80.0) * 255).cpu()
               - torch.round(lq.jpeg_up(ref, (512, 512), 80.0) * 255)).abs()
    share, worst = (lvl <= 1).float().mean().item(), lvl.max().item()
    print(f"[aux] lq card against CPU, one draw handed to both: blur, downsample and noise max error {err:.3e} "
          f"(bound 1e-5); after JPEG and the resize back {share:.4f} of the levels within 1, the largest {worst:.0f} "
          "(bounds 0.99 and 52, one JPEG rounding flip)", flush=True)
    if not (err <= 1e-5 and share >= 0.99 and worst <= 52):
        fail(f"lq card against CPU: stage {err}, levels {share} within 1, worst {worst}")
    rec["lq"] = dict(wall_s=lq_s, launches=got, card_vs_cpu=err, levels_within_1=share)

    # -- RRDBNet x4 (64 features, 23 blocks, grow 32), tiled over a 256^2 input -----------------------------------
    net = tc.seeded_model(lambda: rrdbnet.RRDBNet(scale=4, num_feat=64, num_block=23, num_grow=32), 4, "cuda")
    x = torch.rand(1, 256, 256, 3, generator=torch.Generator(device="cuda").manual_seed(6), device="cuda")
    reset_counts()
    with torch.no_grad():
        up, walls, peak = sync_walls(lambda: rrdbnet.tile_process(net, x, 4))
    no_kernel_launched("RRDBNet")
    if tuple(up.shape) != (1, 1024, 1024, 3) or not torch.isfinite(up).all():
        fail(f"RRDBNet: {tuple(up.shape)}")
    print(f"[aux] {card}: RRDBNet x4 (64, 23 blocks, grow 32; {sum(p.numel() for p in net.parameters()) / 1e6:.2f} M "
          f"parameters, f32, cuDNN) tiled (400 + 10) over 1 x 256^2 -> {tuple(up.shape)} finite; wall "
          f"{walls[-1]:.4f} s (first {walls[0]:.4f}), peak allocated {peak:.2f} GiB", flush=True)
    # profiled last: once the profiler has run, host-bound calls slow down
    profiled = {"rrdbnet": ("RRDBNet tiled call", torch.no_grad()(lambda: rrdbnet.tile_process(net, x, 4)))}
    xc = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(7))
    err = card_vs_cpu("RRDBNet x4 at 1 block, 64^2",
                      tc.seeded_model(lambda: rrdbnet.RRDBNet(scale=4, num_block=1), 5, "cpu"),
                      lambda m, dev: m(xc.to(dev)))
    rec["rrdbnet"] = dict(wall_s=walls, peak_gib=peak, card_vs_cpu=err)
    del up
    torch.cuda.empty_cache()

    # -- MiDaS: DPT-Hybrid, DPT-Large (K1 at head dim 64, 577 tokens), v2.1 at 384, v2.1-small at 256 ---------------
    x01 = torch.rand(2, 384, 384, 3, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda")
    rec["depth"], counts["depth"] = {}, {}
    for i, model_type in enumerate(("dpt_hybrid", "dpt_large", "midas_v21", "midas_v21_small")):
        model = tc.seeded_model(lambda: dpt.build_midas(model_type), 10 + i, "cuda")
        midas = dpt.MiDaSInference(model, model_type)
        depth = tally_shapes(lambda: midas(x01), f"depth {model_type}", None, None, f"launches_{model_type}_call",
                             attn_records, conv_dtype="f32", attn_dims=(64,))
        got, planes = read_counts(), tf32_planes.launches
        blocks = model.cfg.vit_depth if model_type.startswith("dpt") else 0
        if got["flash_attn_fwd"] != blocks or planes != 3 * blocks or sum(got.values()) != blocks:
            fail(f"depth {model_type}: launches {got}, prepass {planes}; expected K1 {blocks}, prepass {3 * blocks}")
        counts["depth"][model_type] = got
        if tuple(depth.shape) != (2, 384, 384, 1) or not torch.isfinite(depth).all():
            fail(f"depth {model_type}: {tuple(depth.shape)}")
        _, walls, peak = sync_walls(lambda: midas(x01))
        positive = (depth > 0).float().mean().item()
        cond = LatentDiffusionTask.depth_conditioning(midas.depth_fn()(x01 * 2 - 1), (48, 48))
        if tuple(cond.shape) != (2, 48, 48, 1) or not (cond.abs() <= 1 + 1e-6).all():
            fail(f"depth {model_type}: depth2image conditioning {tuple(cond.shape)} outside [-1, 1]")
        print(f"[aux] {card}: {model_type} ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, f32) "
              f"on 2 x 384^2 at net size {midas.net_size}: depth (2, 384, 384, 1) finite, {positive:.3f} of it above 0 "
              f"(the head's ReLU at torch's init); K1 {blocks} launches (one a "
              f"ViT block, split-tf32 at head dim 64, each shape held) and the prepass {planes}; depth_fn -> the "
              f"depth2image conditioning (2, 48, 48, 1) in [-1, 1]; wall a call {min(walls):.4f} s, peak allocated "
              f"{peak:.2f} GiB", flush=True)
        profiled[model_type] = (f"{model_type} call", lambda midas=midas: midas(x01))
        del model
        # the copies end without the head's last ReLU: at torch's init it can zero every pixel
        if model_type.startswith("dpt"):
            cut = dataclasses.replace(dpt.VARIANTS[dpt.DPT_TYPES[model_type]], vit_depth=4, hooks=(0, 1, 2, 3),
                                      non_negative=False)
            cpu_model = tc.seeded_model(lambda: dpt.DPTDepthModel(cut), 20 + i, "cpu")
        elif model_type == "midas_v21":
            cpu_model = tc.seeded_model(lambda: dpt.MidasNet(layers=(1, 1, 1, 1), non_negative=False), 20 + i,
                                        "cpu")
        else:
            cpu_model = tc.seeded_model(lambda: dpt.MidasNetSmall(non_negative=False), 20 + i, "cpu")
        xc = x01[:1].cpu()
        err = card_vs_cpu(f"{model_type} cut to {AUX_DEPTH_CUTS[model_type]}, no final ReLU", cpu_model,
                          lambda m, dev: dpt.MiDaSInference(m, model_type)(xc.to(dev)))
        rec["depth"][model_type] = dict(wall_s=walls, peak_gib=peak, launches=got, prepass=planes, card_vs_cpu=err,
                                        positive_share=positive)
        torch.cuda.empty_cache()

    # -- LLaVA-MPT-7B with a CLIP ViT-L/14 tower at 224 (layer -2): 32 greedy tokens ------------------------------
    t = time.perf_counter()
    tower = tc.seeded_model(lambda: CLIPVisionModel(tc.clip_vision_config()), 30, "cuda")
    cfg7b = dataclasses.replace(llava_mpt.MPT_7B, mm_hidden_size=1024)
    lm = tc.seeded_model(lambda: llava_mpt.MPTModel(cfg7b), 31, "cuda")
    build_s = time.perf_counter() - t
    tok = tc.word_tokenizer(cfg7b.vocab_size, cfg7b.max_seq_len, "plain")
    im_patch = tok.convert_tokens_to_ids("<im_patch>")
    n_patches = (224 // 14) ** 2

    def captioner(model, vision):
        def vision_fn(px):
            return llava_mpt.clip_select_features(vision(pixel_values=px, output_hidden_states=True).hidden_states, -2)
        return llava_mpt.LlavaMPT(model, vision_fn, im_patch)

    prompt = tok("describe this image and its style in a very detailed manner").input_ids + [im_patch] * n_patches
    px = torch.randn(2, 3, 224, 224, generator=torch.Generator(device="cuda").manual_seed(9), device="cuda")
    ids = torch.tensor([prompt] * 2, device="cuda")
    llava = captioner(lm, tower)
    reset_counts()
    toks, walls, peak = sync_walls(lambda: llava.generate(ids, px, torch.ones_like(ids, dtype=torch.bool), 32))
    no_kernel_launched("LLaVA-MPT generate")
    if tuple(toks.shape) != (2, 32) or int(toks.min()) < 0 or int(toks.max()) >= cfg7b.vocab_size:
        fail(f"LLaVA-MPT: tokens {tuple(toks.shape)} in [{int(toks.min())}, {int(toks.max())}]")
    params = sum(p.numel() for p in lm.parameters())
    print(f"[aux] {card}: LLaVA-MPT-7B ({params / 1e9:.3f} B parameters, f32; CLIP ViT-L/14 tower at 224, layer -2, "
          f"{n_patches} patches; built in {build_s:.1f}s): 2 images, a prompt of {len(prompt)} tokens, 32 greedy "
          f"tokens with the KV cache -> {tuple(toks.shape)}; wall {walls[-1]:.4f} s (first {walls[0]:.4f}; "
          f"{walls[-1] / 32 * 1e3:.2f} ms a token with the prefill), peak allocated {peak:.2f} GiB; no kernel of the "
          "port", flush=True)
    profiled["llava_mpt"] = ("LLaVA-MPT generate",
                             lambda: llava.generate(ids, px, torch.ones_like(ids, dtype=torch.bool), 32))
    cpu_lm = tc.seeded_model(lambda: llava_mpt.MPTModel(dataclasses.replace(cfg7b, n_layers=1)), 32, "cpu")
    cpu_tower = tc.seeded_model(lambda: CLIPVisionModel(tc.clip_vision_config(num_hidden_layers=2)), 33, "cpu")
    pxc, idc = px[:1].cpu(), ids[:1].cpu()

    class Pair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lm, self.tower = cpu_lm, cpu_tower

    err = card_vs_cpu("LLaVA-MPT at 1 layer with the tower at 2, caption logits", Pair(),
                      lambda m, dev: captioner(m.lm, m.tower).caption_logits(idc.to(dev), pxc.to(dev)))
    rec["llava_mpt"] = dict(parameters=params, build_s=build_s, wall_s=walls, peak_gib=peak, card_vs_cpu=err)
    for key, (what, call) in profiled.items():  # where the device time goes, by kernel
        (rec["depth"][key] if key in rec["depth"] else rec[key])["kernels"] = kernel_split(what, call)
    del profiled, llava, lm, tower, net
    torch.cuda.empty_cache()

    rec["launches"] = counts
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[aux] phase 17 wall {rec['phase_s']:.1f} s", flush=True)
    return rec



# Phase 18: the parallel paths. One NCCL rank in this process (a real group of one: the script needs one card, and NCCL
# takes no two ranks on one device), then two gloo ranks sharing that card, each a process of its own.
PARALLEL_MODES = ("sharded", "tp", "sp", "pp")
PARALLEL_GLOO_TIMEOUT_S = 60  # a collective that one rank gives up on fails on the other within a minute
# The two-rank runs of tp and sp, against the one-rank output: the tensor-parallel projections sum two bf16 partial
# products in f32 and round once more, the local queries' projections run at half the rows (other GEMM tiles), and
# random weights carry such one-step bf16 differences through 28 blocks, the VAE decode and the color fix; 5e-2 of
# the [0, 1] image, about 13 8-bit levels.
PARALLEL_TWO_RANK_BOUND = 5e-2


def same_arithmetic(pipe, mode, microbatches):
    """The parallel entry point ``mode`` of ``pipe`` over ``group``, and the
    one-card call of the same arithmetic at one rank: ``process`` itself, or
    for pp ``process`` with the blocks run on each microbatch as the stage
    does (the embedders and the final layer on the whole batch)."""
    import torch

    if mode == "pp":
        def dit_forward(z, t, yy, mask):
            dit = pipe.dit
            tokens, y_tokens, t6, t_emb, hw, _ = dit.prepare(z, t, yy)
            mb, outs = tokens.shape[0] // microbatches, []
            for m in range(microbatches):
                h = tokens[m * mb:(m + 1) * mb]
                for blk in dit.blocks:
                    h = blk(h, y_tokens[m * mb:(m + 1) * mb], t6[m * mb:(m + 1) * mb], mask, hw)
                outs.append(h)
            return dit.finish(torch.cat(outs), t_emb, hw)

        same = lambda lq, y: pipe.process(lq, y, dit_forward=dit_forward)  # noqa: E731
    else:
        same = pipe.process
    return same


def parallel_entry(pipe, mode, group, microbatches):
    return {"sharded": lambda: pipe.sharded(group), "tp": lambda: pipe.tp(group), "sp": lambda: pipe.sp(group),
            "pp": lambda: pipe.pp(group, microbatches)}[mode]()


GLOO_PROBES = ("all_reduce", "broadcast", "all_gather_into_tensor", "send_recv")  # send_recv last: it may abort


def probe_gloo_rank(rank, port, out_dir):
    """One of two gloo ranks on the one card that probe which collectives
    gloo takes on CUDA tensors of the sizes the modes move (64 MB), each in a
    group of its own. A rank writes each probe's outcome as it comes (None:
    taken; else the error), and "started" before it: gloo may end the process
    on a refused one (an ``IoException`` thrown in its transport thread)."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    timeout = datetime.timedelta(seconds=PARALLEL_GLOO_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2, timeout=timeout)
    n = 1 << 24
    probes = {
        "all_reduce": lambda g: dist.all_reduce(torch.ones(n, device="cuda"), group=g),
        "broadcast": lambda g: dist.broadcast(torch.ones(n, device="cuda"), src=0, group=g),
        "all_gather_into_tensor": lambda g: dist.all_gather_into_tensor(
            torch.empty(2 * n, device="cuda"), torch.ones(n, device="cuda"), group=g),
        "send_recv": lambda g: (dist.send(torch.ones(n, device="cuda"), dst=1, group=g) if rank == 0
                                else dist.recv(torch.empty(n, device="cuda"), src=0, group=g)),
    }
    out, path = {}, os.path.join(out_dir, f"probe.rank{rank}.json")

    def write():
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)

    for name in GLOO_PROBES:
        out[name] = "started"
        write()
        try:
            probes[name](dist.new_group([0, 1], timeout=timeout))
            torch.cuda.synchronize()
            out[name] = None
        except RuntimeError as exc:
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
        write()
    dist.destroy_process_group()


def probe_gloo_cuda():
    """Which collectives gloo takes on CUDA tensors, from two probing
    processes: name -> None (taken on both ranks) or why not. A probe counts
    as refused only where a rank raised in it, or where its process ended
    inside it; anything else (a rank raising outside a probe, a probe not
    reached, a process ending with every probe taken) fails the phase."""
    import torch.multiprocessing as mp

    from instarevive_tpu_torch.parallel.dist import free_port

    work = tempfile.mkdtemp(prefix="chip_smoke_probe_")
    atexit.register(shutil.rmtree, work, True)
    ended = None
    try:
        mp.start_processes(probe_gloo_rank, args=(free_port(), work), nprocs=2, start_method="spawn")
    except mp.ProcessExitedException as exc:  # a signal or a C++ abort, not a Python exception
        ended = str(exc)
    recs = []
    for r in range(2):
        path = os.path.join(work, f"probe.rank{r}.json")
        recs.append({})
        if os.path.exists(path):
            with open(path) as f:
                recs[r] = json.load(f)
    out = {}
    for name in GLOO_PROBES:
        got = [rec.get(name, "not reached") for rec in recs]
        if "not reached" in got:
            fail(f"parallel gloo probe {name}: not reached on rank {got.index('not reached')} ({ended})")
        why = [g for g in got if g not in (None, "started")]
        if "started" in got:
            why.insert(0, f"rank {got.index('started')}'s process ended inside the probe ({ended})")
        out[name] = "; ".join(why) or None
    if ended and all(v is None for v in out.values()):
        fail(f"parallel gloo probes: every collective was taken, but a probing process ended: {ended}")
    return out, ended


def parallel_gloo_rank(rank, port, out_dir, probes):
    """One of the two gloo ranks on the one card: every mode whose
    collectives gloo takes on CUDA tensors (``probes``, from
    ``probe_gloo_cuda``), at full width (v1 in bf16, 4x512x512), each in a
    group of its own, against the one-rank arithmetic; K1's launches by
    shape; the walls (through host memory: no measure of speed)."""
    import copy
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from instarevive_tpu_torch.ops.attention import flash_attention
    from instarevive_tpu_torch.parallel.pp import MICROBATCHES
    from instarevive_tpu_torch.pipelines.build import set_precision
    from instarevive_tpu_torch.tools.time_restore import build_v1, wall

    torch.cuda.set_device(0)
    set_precision()
    timeout = datetime.timedelta(seconds=PARALLEL_GLOO_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2, timeout=timeout)

    def pair():
        return dist.new_group([0, 1], timeout=timeout)

    result = {"rank": rank, "modes": {}}
    needs = {"sharded": ("all_gather_into_tensor",), "tp": ("all_reduce",),
             "sp": ("all_gather_into_tensor",), "pp": ("send_recv", "broadcast")}
    try:
        base = build_v1(REPO)
        y = base.pipe.dit.y_embedder.y_embedding[:300][None].float().repeat(base.batch, 1, 1)
        lq = base.lq
        with torch.inference_mode():
            plain = base.pipe.process(lq, y)
            halves = torch.cat([base.pipe.process(lq[:2], y[:2]), base.pipe.process(lq[2:], y[2:])])
            micro = same_arithmetic(base.pipe, "pp", MICROBATCHES)(lq, y)
        for mode in PARALLEL_MODES:
            group = pair()
            refused = [probes[c] for c in needs[mode] if probes[c]]
            if refused:
                result["modes"][mode] = {"refused": refused}
                continue
            pipe = copy.deepcopy(base.pipe) if mode in ("tp", "pp") else base.pipe
            try:
                fn = parallel_entry(pipe, mode, group, MICROBATCHES)
                flash_attention.launches, flash_attention.shapes = 0, {}
                with torch.inference_mode():
                    out = fn(lq, y)
                torch.cuda.synchronize()
                shapes, flash_attention.shapes = dict(flash_attention.shapes), None  # one call's launches
                with torch.inference_mode():
                    walls = wall(lambda: fn(lq, y), 2)
            except Exception as exc:  # a real failure: the probe took every collective this mode needs
                result["modes"][mode] = {"failed": f"{type(exc).__name__}: {str(exc).splitlines()[0]}"}
                break  # the other rank's next collective times out, and it stops too
            finally:
                flash_attention.shapes = None
            ref = {"sharded": halves, "pp": micro}.get(mode, plain)
            result["modes"][mode] = {
                "same_bits_as": {"sharded": "process on each rank's half", "pp": "process, blocks per microbatch"}.get(
                    mode, "process"),
                "bitwise": bool(torch.equal(out, ref)), "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                "max_abs_err_vs_process": (out.float() - plain.float()).abs().max().item(),
                "finite": bool(torch.isfinite(out).all()), "shape": list(out.shape),
                "k1_shapes": {",".join(map(str, k)): v for k, v in shapes.items()},
                "wall_s_through_host": walls, "blocks_held": len(pipe.dit.blocks)}
            if mode in ("tp", "pp"):
                del pipe
                torch.cuda.empty_cache()
    except Exception as exc:
        result["error"] = f"{type(exc).__name__}: {exc}"
    finally:
        with open(os.path.join(out_dir, f"gloo.rank{rank}.json"), "w") as f:
            json.dump(result, f)
        dist.destroy_process_group()


def dmd_parallel_steps(cfg_path, mesh, batch, steps=3):
    """``steps`` bf16 DMD steps at full width (batch 2 at 512x512, as phase 8)
    of a task laid out by ``mesh`` (None: unwrapped) on one loader batch:
    the metrics, the walls, peak memory, launches and the generator's
    weights, EMA and the fake score's weights after the steps."""
    import gc

    import torch

    from instarevive_tpu_torch.config import load_config
    from instarevive_tpu_torch.train import launcher
    from instarevive_tpu_torch.tools.time_train import train_argv

    gc.collect()  # a task is a reference cycle (its step's hooks): free the last one before this one's peak
    torch.cuda.empty_cache()
    args = launcher.parse_args(train_argv(cfg_path, "unused", "unused", steps))
    task = launcher.DMDTask(args, load_config(cfg_path), torch.device("cuda"), mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, walls = [], []
    for _ in range(steps):
        t = time.perf_counter()
        m = task.run_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    gen, fake = task.states
    out = {"metrics": metrics, "walls": walls, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": read_counts()}
    # the weights leave the card, so the next run's peak is its own
    for name, sd in (("gen", gen.module_state_dict()), ("ema", gen.ema_state_dict()), ("fake", fake.module_state_dict())):
        out[name] = {k: v.detach().cpu() for k, v in sd.items()}
    del task, gen, fake
    gc.collect()
    torch.cuda.empty_cache()
    return out


def parallel_phase(conv_records, swin_records, attn_records):
    """Phase 18 (module docstring): sharded, tp, sp and pp of ``process`` and
    the DMD step under DDP and FSDP2 through a real NCCL group of one rank,
    bit for bit against the one-card arithmetic; then two gloo ranks on the
    one card, each mode (or its refusal) against the one-rank output."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    from instarevive_tpu_torch.parallel.dist import free_port
    from instarevive_tpu_torch.parallel.mesh import TrainMesh
    from instarevive_tpu_torch.parallel.pp import MICROBATCHES
    from instarevive_tpu_torch.tools.time_restore import build_v1, wall

    card = card_line()
    timing = {"card": card, "nccl1": {}, "gloo2": {}}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        base = build_v1(REPO)
        lq = base.lq
        y = base.pipe.dit.y_embedder.y_embedding[:300][None].float().repeat(base.batch, 1, 1)
        for mode in PARALLEL_MODES:
            pipe = copy.deepcopy(base.pipe) if mode in ("tp", "pp") else base.pipe
            fn = parallel_entry(pipe, mode, group, MICROBATCHES)
            with torch.inference_mode():
                ref = same_arithmetic(base.pipe, mode, MICROBATCHES)(lq, y)
                out = tally_shapes(lambda: fn(lq, y), f"parallel {mode} (NCCL, 1 rank)", conv_records, swin_records,
                                   f"launches_parallel_{mode}", attn_records, attn_dims=(72, 512))
                launches = read_counts()
                plain = base.pipe.process(lq, y)
                walls = wall(lambda: fn(lq, y), 3)
                plain_walls = wall(lambda: base.pipe.process(lq, y), 3)
            check_image(out, (base.batch, base.size, base.size, 3), f"parallel {mode}")
            bitwise = bool(torch.equal(out, ref))
            diff = (out.float() - plain.float()).abs().max().item()
            rec = {"bitwise": bitwise, "same_bits_as": "process, blocks per microbatch" if mode == "pp" else "process",
                   "max_abs_err_vs_process": diff, "launches": launches, "wall_s": walls, "process_wall_s": plain_walls,
                   "blocks_held": len(pipe.dit.blocks)}
            timing["nccl1"][mode] = rec
            print(f"[parallel] {mode} NCCL 1 rank 4x512x512: bit for bit {bitwise} against {rec['same_bits_as']}, "
                  f"max|out - process| {diff:.3e}, launches {launches}, warm s {', '.join(f'{t:.4f}' for t in walls)} "
                  f"(process {', '.join(f'{t:.4f}' for t in plain_walls)}) [{card}]", flush=True)
            if not bitwise:
                fail(f"parallel {mode} at one NCCL rank is not bit for bit {rec['same_bits_as']}")
            if mode in ("tp", "pp"):
                del pipe
                torch.cuda.empty_cache()
        del base
        torch.cuda.empty_cache()

        # the DMD step unwrapped, under DDP(1) and under FSDP2(1): the same draws, the same batch
        cfg_path = os.path.join(REPO, "configs", "instarevive_v1.yaml")
        batch = {"hq": np.random.default_rng(18).integers(0, 256, (2, 512, 512, 3), dtype=np.uint8)}
        want = dmd_parallel_steps(cfg_path, None, batch)
        for kind, names in (("ddp1", ("data",)), ("fsdp1", ("fsdp",))):
            got = dmd_parallel_steps(cfg_path, TrainMesh(init_device_mesh("cuda", (1,), mesh_dim_names=names)), batch)
            same = got["metrics"] == want["metrics"] and all(
                torch.equal(got[t][k], want[t][k]) for t in ("gen", "ema", "fake") for k in want[t])
            worst = max((got[t][k].float() - want[t][k].float()).abs().max().item()
                        for t in ("gen", "ema", "fake") for k in want[t])
            rec = {"bitwise": same, "max_abs_weight_err": worst, "metrics": got["metrics"], "walls_s": got["walls"],
                   "plain_walls_s": want["walls"], "peak_gib": got["peak_gib"], "plain_peak_gib": want["peak_gib"],
                   "launches": got["launches"], "plain_launches": want["launches"]}
            timing["nccl1"][f"dmd_{kind}"] = rec
            print(f"[parallel] DMD step bf16 batch 2 at 512^2 under {kind}: bit for bit {same} against the unwrapped "
                  f"step (largest weight difference {worst:.3e}); s/step {', '.join(f'{t:.4f}' for t in got['walls'])} "
                  f"against {', '.join(f'{t:.4f}' for t in want['walls'])}; peak {got['peak_gib']:.2f} GiB against "
                  f"{want['peak_gib']:.2f}; launches {got['launches']} [{card}]", flush=True)
            if not same:
                fail(f"the DMD step under {kind} is not bit for bit the unwrapped step")
            if got["launches"] != want["launches"]:
                fail(f"the DMD step under {kind} launched {got['launches']}, unwrapped {want['launches']}")
            del got
            torch.cuda.empty_cache()
        del want
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # two gloo ranks sharing the card, in processes of their own
    work = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    atexit.register(shutil.rmtree, work, True)
    t0 = time.time()
    probes, ended = probe_gloo_cuda()
    print(f"[parallel] two gloo ranks on the one card: collectives on CUDA tensors "
          f"{ {k: ('taken' if v is None else v) for k, v in probes.items()} }"
          + (f"; a probing process ended: {ended}" if ended else "")
          + f" ({time.time() - t0:.1f}s with the start)", flush=True)
    try:
        mp.start_processes(parallel_gloo_rank, args=(free_port(), work, probes), nprocs=2, start_method="spawn")
    except mp.ProcessExitedException as exc:  # every collective it ran was taken by the probe: a real failure
        fail(f"parallel two gloo ranks: {exc}")
    ranks = []
    for r in range(2):
        path = os.path.join(work, f"gloo.rank{r}.json")
        if not os.path.exists(path):
            fail(f"parallel two gloo ranks: rank {r} wrote no result")
        with open(path) as f:
            ranks.append(json.load(f))
        if "error" in ranks[r]:
            fail(f"parallel two gloo ranks: rank {r}: {ranks[r]['error']}")
    held = {(*r["shape"], r["masked"], False): r for r in attn_records if r["dtype"] == "bf16"}
    for mode in PARALLEL_MODES:
        recs = [rk["modes"].get(mode) for rk in ranks]
        # only a collective that failed the probe on a rank makes a refusal; any other failure fails the phase
        for r, rec in enumerate(recs):
            if rec is None or "failed" in rec:
                fail(f"parallel {mode} at two gloo ranks: rank {r}: "
                     f"{'did not run it' if rec is None else rec['failed']}")
        if "refused" in recs[0]:
            print(f"[parallel] {mode} two gloo ranks: refused by gloo on CUDA tensors: {recs[0]['refused']} "
                  f"(held on the CPU only: tests/test_torch_parallel.py)", flush=True)
            continue
        rec = recs[0]
        shapes = {tuple(int(v) if v.isdigit() else v == "True" for v in k.split(",")): n
                  for k, n in rec["k1_shapes"].items()}
        missing = sorted(set(shapes) - set(held))
        if missing:
            fail(f"parallel {mode} two gloo ranks: K1 ran at shapes the kernel phase did not hold: {missing}")
        for shape, r in held.items():
            r[f"launches_parallel_gloo2_{mode}"] = shapes.get(shape, 0)
        exact = mode in ("sharded", "pp")
        oks = [r["finite"] and (r["bitwise"] if exact else r["max_abs_err"] <= PARALLEL_TWO_RANK_BOUND)
               for r in recs]
        errs = ", ".join(f"{r['max_abs_err']:.3e}" for r in recs)
        print(f"[parallel] {mode} two gloo ranks 4x512x512: "
              + (f"bit for bit {[r['bitwise'] for r in recs]} (ranks 0, 1) against {rec['same_bits_as']}" if exact
                 else f"max_abs_err {errs} (ranks 0, 1) against process (bound {PARALLEL_TWO_RANK_BOUND})")
              + f", max|out - process| {rec['max_abs_err_vs_process']:.3e}, K1 by shape {rec['k1_shapes']}, "
              f"blocks held {rec['blocks_held']}; walls {rec['wall_s_through_host']} s through host memory "
              f"(no measure of speed) [{card}]", flush=True)
        for r, ok in enumerate(oks):
            if not ok:
                fail(f"parallel {mode} at two gloo ranks: rank {r}: {recs[r]}")
    timing["gloo2"] = {"probes": probes, "probe_process_ended": ended, "rank0": ranks[0], "rank1": ranks[1]}
    return timing


# Phase 19: the training-validation tools. The toy tool (tools/train_validation.py) runs whole through its main() in
# f32 (K1 and K2 at head dim 32) at its defaults but for these step counts: at its defaults it took 239 s on an H100
# (teacher 58 s, DMD 127 s, Reflow 52 s; tools/time_train_validation.py). The teacher keeps its 2,000 steps (at fewer
# its 20-step samples run out of range and DMD cannot beat its init); on the card the DMD EMA's PSNR passed its init's
# (14.04 dB) between steps 700 and 800 and stood 1.09 dB above it at 1,200, and the Reflow EMA's moment distance passed
# its init's by step 100 (time_train_validation.py --probe --dmd_steps 1200 --reflow_steps 500).
TRAINVAL_TOY_ARGV = ["--dmd_steps", "1200", "--reflow_steps", "500"]
# The production tool's stages at full XL-2 width in bf16 under dots: its teacher cut to a number of steps at which
# its own teacher assert holds on the card (read every 5: on an H100 the loss went 2.10 -> 0.56 by step 49 and 0.34
# by step 99), 2 pair batches of 4, 5 DMD steps at batch 2 (10 until phase 20 needed the room) and an eval over 4
# held noises (the DMD-gap assert belongs to the full-length run).
TRAINVAL_PROD_ARGV = ["--teacher_steps", "50", "--chunk", "5", "--pairs", "8", "--dmd_steps", "5", "--held", "4"]


class KeptGradients:
    """A train state whose ``apply_gradients`` also keeps the gradients (for
    the card-against-CPU check of a tool's step, which applies its own)."""

    def __init__(self, state):
        self.state, self.grads = state, None

    def gradients(self, loss):
        return self.state.gradients(loss)

    def apply_gradients(self, grads):
        self.grads = [g.detach().cpu() for g in grads]
        return self.state.apply_gradients(grads)


def stage_deltas(snaps, end_counts):
    """Each stage's launches from the counts taken as the stages began (``snaps``: (name, counts)) and at the end."""
    marks = snaps + [("end", end_counts)]
    return {name: {k: marks[i + 1][1][k] - counts[k] for k in counts} for i, (name, counts) in enumerate(snaps)}


def all_counts():
    from instarevive_tpu_torch.ops.tf32_planes import tf32_planes

    return {**read_counts(), "tf32_planes": tf32_planes.launches}


def tally_held(fns, run, what):
    """Run ``run`` with each wrapper of ``fns`` ({wrapper: (held keys, legend[, which shapes must be held])})
    tallying its launches by shape; fails if a tally and a count disagree or a shape is not held. Returns (run's
    output, {name: {shape: n}})."""
    import torch

    for fn in fns:
        fn.shapes = {}
    try:
        out = run()
        torch.cuda.synchronize()
        seen = {fn: dict(fn.shapes) for fn in fns}
    finally:
        for fn in fns:
            fn.shapes = None
    for fn, (held, legend, *selected) in fns.items():
        shapes = seen[fn]
        if sum(shapes.values()) != fn.launches:
            fail(f"{what}: {fn.__name__}: {sum(shapes.values())} launches tallied by shape, {fn.launches} counted")
        missing = sorted({s for s in shapes if not selected or selected[0](s)} - set(held))
        if missing:
            fail(f"{what}: {fn.__name__} ran at shapes its kernel phase did not hold: {missing}")
        print(f"[shapes] {what}: {fn.__name__} launches by {legend}: "
              + ", ".join(f"{k}x{v}" for k, v in sorted(shapes.items(), key=str)), flush=True)
    return out, {fn.__name__: seen[fn] for fn in fns}


def trainval_toy(d32_held, work):
    """(a) of phase 19: the toy tool's ``main`` whole on the card (every JAX
    assert), K1 and K2 launched at head dim 32 only, at shapes ``d32_phase``
    held, each stage's launches held to what its steps imply. Returns its
    record (walls, steps/s, launches, peak memory, the figures main
    returns)."""
    import torch

    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.tools import train_validation as TV

    args = TV.parse_args(TRAINVAL_TOY_ARGV)
    held_fwd = {(*k, lse) for k in d32_held for lse in (False, True)}
    snaps = []

    def on_stage(name):
        torch.cuda.synchronize()
        snaps.append((name, all_counts()))

    def run():
        try:
            return TV.main(["--out", os.path.join(work, "train_validation.md"), *TRAINVAL_TOY_ARGV], on_stage=on_stage)
        except AssertionError as e:
            fail(f"phase 19, the toy tool's main: {e}")

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res, shapes = tally_held({A.flash_attention: (held_fwd, "(B, H, Nq, Nk, D, masked, with log-sum-exp)"),
                              A.flash_dq: (d32_held, "(B, H, Nq, Nk, D, masked)"),
                              A.flash_dkv: (d32_held, "(B, H, Nq, Nk, D, masked)")}, run, "toy tool")
    wall = time.time() - t0
    totals = all_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    by_stage = stage_deltas(snaps[:-1], snaps[-1][1])  # the last mark is 'end'
    per_fwd = 2 * args.depth  # a self- and a cross-attention a block
    steps = res["steps"]
    want = {  # (forwards without grad, forwards with grad) a stage: K1 for both, K2 (dq, dk/dv) once for each second
        "teacher": (0, steps["teacher"]), "pairs": (8 * 20, 0), "dmd": (2 * steps["dmd"], 2 * steps["dmd"]),
        "quality": (20 + 2, 0), "reflow": (0, steps["reflow"]), "reflow_eval": (2, 0)}
    for stage, (plain, grad) in want.items():
        got = by_stage[stage]
        expect = {k: 0 for k in got}
        expect.update(flash_attn_fwd=per_fwd * (plain + grad), flash_attn_bwd_dq=per_fwd * grad,
                      flash_attn_bwd_dkv=per_fwd * grad, tf32_planes=3 * per_fwd * (plain + grad) + 4 * per_fwd * grad)
        if got != expect:
            fail(f"phase 19, toy tool, stage {stage}: launches {got}, expected {expect}")
    if any(shape[4] != 32 for counts in shapes.values() for shape in counts):
        fail(f"phase 19, toy tool: attention at another head dim than 32: {shapes}")
    per_step = {stage: {k: v / steps[stage] for k, v in by_stage[stage].items() if v}
                for stage in ("teacher", "dmd", "reflow")}
    rec = dict(argv=TRAINVAL_TOY_ARGV, wall_s=wall, walls_s=res["walls"], steps=steps,
               steps_per_s={k: steps[k] / res["walls"][k] for k in ("teacher", "dmd", "reflow")},
               launches=totals, launches_by_stage=by_stage, launches_per_step=per_step, peak_gib=peak,
               psnr=res["psnr"], ssim=res["ssim"], reflow_moment_dist=res["reflow_moment_dist"],
               curves={k: [v[0], v[-1]] for k, v in res["curves"].items()}, shapes={k: {str(s): n for s, n in v.items()}
                                                                             for k, v in shapes.items()})
    print(f"[trainval] toy tool main() at its defaults{' + ' + ' '.join(TRAINVAL_TOY_ARGV) if TRAINVAL_TOY_ARGV else ''}"
          f" (f32, DiT {args.hidden}h/{args.depth}L/{args.heads} heads = head dim {args.hidden // args.heads}, batch "
          f"{args.batch}, {args.size}^2): every assert held; wall {wall:.1f} s; stages (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in res["walls"].items())
          + "; steps/s " + ", ".join(f"{k} {v:.1f}" for k, v in rec["steps_per_s"].items())
          + f"; launches a step {per_step}; peak {peak:.2f} GiB; PSNR EMA {res['psnr']['ema']:.2f} against init "
          f"{res['psnr']['init']:.2f}; Reflow moment distance EMA {res['reflow_moment_dist']['ema']:.4f} against init "
          f"{res['reflow_moment_dist']['init']:.4f}", flush=True)
    return rec


def trainval_prod(attn_records, lse_records, dq_records, dkv_records, conv_records, norm_records, work):
    """(b) of phase 19: the production tool's stage functions at full XL-2
    width in bf16 under dots (TRAINVAL_PROD_ARGV): its teacher assert holds,
    every curve and eval figure is finite, and every K1, K2, K3 and K5 shape
    the stages launch is one the kernel phases held. Returns its record."""
    import copy

    import torch

    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3
    from instarevive_tpu_torch.ops.norm_kernels import gn_affine, group_norm_silu, upsample2x_nearest
    from instarevive_tpu_torch.tools import train_validation as TV
    from instarevive_tpu_torch.tools import train_validation_prod as TVP

    import math

    stats_records, apply_records, up_records = norm_records
    bf16 = lambda recs, *extra: {(*r["shape"], r["masked"], *extra) for r in recs if r["dtype"] == "bf16"}  # noqa: E731
    nhwc = lambda recs: {(*r["shape"], r["dtype"]) for r in recs}  # noqa: E731
    held = {A.flash_attention: (bf16(attn_records, False) | bf16(lse_records, True),
                                "(B, H, Nq, Nk, D, masked, with log-sum-exp)"),
            A.flash_dq: (bf16(dq_records), "(B, H, Nq, Nk, D, masked)"),
            A.flash_dkv: (bf16(dkv_records), "(B, H, Nq, Nk, D, masked)"),
            gn_silu_conv3x3: (nhwc(conv_records), "(N, H, W, C, Co, dtype)"),
            gn_affine: (nhwc(stats_records), "(N, H, W, C, dtype)"),
            group_norm_silu: (nhwc(apply_records), "(N, H, W, C, dtype)"),
            upsample2x_nearest: (nhwc(up_records), "(N, H, W, C, dtype)")}
    args = TVP.parse_args(["--device", "cuda", "--out", os.path.join(work, "train_validation_prod.md"),
                           *TRAINVAL_PROD_ARGV])
    walls, snaps, out = {}, [], {}

    def mark(name):
        torch.cuda.synchronize()
        snaps.append((name, all_counts()))
        walls[name] = time.time()

    def stages():
        mark("build")
        run = TVP.Run(TVP.geometry(False), "cuda", seed=args.seed)
        mark("teacher")
        curve_a, steps_a, _ = TVP.teacher_stage(run, args)
        try:
            TV.check_teacher(curve_a)
        except AssertionError as e:
            fail(f"phase 19, the production tool's teacher at {steps_a} steps: {e} ({curve_a})")
        teacher = TVP.frozen_bf16(run.dit)
        teacher_eps = run.eps(teacher)
        mark("pairs")
        pair_noise, pair_latent = TVP.pairs_stage(run, teacher_eps, args)
        mark("dmd")
        gen = TVP.load_f32(run.dit, teacher)
        fake = copy.deepcopy(gen)
        gen_state, fake_state = TVP.dmd_states(run, gen, fake, args)
        curve_b, _ = TVP.dmd_stage(run, gen_state, fake_state, TVP.dmd_step_fn(run, gen, fake, teacher, args),
                                   pair_noise, pair_latent, args)
        del fake_state, fake
        mark("eval")
        held_noise = run.randn(args.held, run.size, run.size, TVP.CH)
        held_tgt = TVP.held_targets(run, teacher_eps, held_noise, args.teacher_batch)
        ema = TV.with_weights(gen, gen_state.ema_state_dict())
        del gen_state
        rows = [("init", teacher_eps), ("trained", run.eps(gen)), ("ema", run.eps(ema))]
        results, niqe_teacher = TVP.evaluate(run, TVP.build_vae(run), rows, held_noise, held_tgt, args.maxt,
                                             run.geo["block_size"])
        mark("end")
        out.update(curves={"teacher": curve_a, "dmd": curve_b}, steps={"teacher": steps_a, "dmd": args.dmd_steps},
                   pairs=int(pair_noise.shape[0] * pair_noise.shape[1]), results=results, niqe_teacher=niqe_teacher)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    _, shapes = tally_held(held, stages, "production tool at XL-2")
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    by_stage = stage_deltas(snaps[:-1], snaps[-1][1])
    names = [name for name, _ in snaps]
    stage_walls = {name: walls[names[i + 1]] - walls[name] for i, name in enumerate(names[:-1])}
    figures = [v for curve in out["curves"].values() for point in curve for v in point[1:]]
    figures += [v for row in out["results"].values() for v in row] + [out["niqe_teacher"]]
    if not (out["curves"]["dmd"] and all(math.isfinite(v) for v in figures)):
        fail(f"phase 19, production tool: a figure is not finite or no DMD metric was read: {out}")
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "gn_silu_conv3x3", "gn_stats_fold"):
        if not sum(stage[name] for stage in by_stage.values()):
            fail(f"phase 19, production tool: {name} was never launched")
    rec = dict(argv=TRAINVAL_PROD_ARGV, walls_s=stage_walls, steps=out["steps"], pairs=out["pairs"],
               s_per_step={k: stage_walls[k] / out["steps"][k] for k in ("teacher", "dmd")}, peak_gib=peak,
               launches_by_stage=by_stage, teacher_curve=out["curves"]["teacher"], dmd_curve=out["curves"]["dmd"],
               results=out["results"], niqe_teacher=out["niqe_teacher"],
               shapes={k: {str(s): n for s, n in v.items()} for k, v in shapes.items()})
    print(f"[trainval] production tool's stages at XL-2 (bf16, dots; {' '.join(TRAINVAL_PROD_ARGV)}): teacher loss "
          f"{out['curves']['teacher'][0][1]:.4f} -> {out['curves']['teacher'][-1][1]:.4f} in {out['steps']['teacher']} "
          f"steps (the tool's assert held); stages (s) " + ", ".join(f"{k} {v:.2f}" for k, v in stage_walls.items())
          + f"; s a step: teacher {rec['s_per_step']['teacher']:.3f}, DMD {rec['s_per_step']['dmd']:.3f}; peak "
          f"{peak:.2f} GiB; eval (latent PSNR, SSIM, pixel PSNR, SSIM, NIQE) {out['results']}, teacher NIQE "
          f"{out['niqe_teacher']:.3f}; launches by stage {by_stage}", flush=True)
    return rec


def trainval_card_against_cpu(attn_records, lse_records, dq_records):
    """(c) of phase 19: one teacher step and two DMD steps of the production
    tool at DiT depth 2, full width, f32, on the card and on the CPU: the same
    weights and draws (made on the CPU and handed in). Losses and metrics
    relative to themselves, each gradient relative to its model's largest
    magnitude, under TRAIN_F32_BOUND. The DMD steps' teacher holds bf16
    weights and computes in f32 (as the f32 DiT does); DM is exercised in the
    second step, once the fake score has moved."""
    import copy

    import torch

    from instarevive_tpu_torch.nn.layers import set_compute_dtype
    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.tools import train_validation as TV
    from instarevive_tpu_torch.tools import train_validation_prod as TVP
    from instarevive_tpu_torch.train.state import TrainState

    geo = TVP.geometry(False)
    geo["dit"] = dict(geo["dit"], depth=2)
    args = TVP.parse_args(["--device", "cuda"])
    runs = {dev: TVP.Run(geo, dev, seed=0, dtype=None) for dev in ("cpu", "cuda")}
    start = copy.deepcopy(runs["cpu"].dit.state_dict())
    g = torch.Generator().manual_seed(19)
    bt, bd, s = args.teacher_batch, args.dmd_batch, geo["size"]
    x0 = TVP.synth_latents(g, bt, s)
    t = torch.randint(0, 1000, (bt,), generator=g)
    noise = torch.randn(x0.shape, generator=g)
    batch = {"noise": torch.randn(bd, s, s, 4, generator=g), "latent": torch.tanh(torch.randn(bd, s, s, 4, generator=g))}
    shape = (bd, s, s, 4)
    draws = [{"t_dm": torch.randint(20, 979, (bd,), generator=g), "noise_dm": torch.randn(shape, generator=g),
              "t_fake": torch.randint(0, 1000, (bd,), generator=g), "noise_fake": torch.randn(shape, generator=g)}
             for _ in range(2)]
    held = {(*r["shape"], r["masked"], lse) for recs, lse in ((attn_records, False), (lse_records, True))
            for r in recs if r["dtype"] == "f32"}
    held_bwd = {(*r["shape"], r["masked"]) for r in dq_records if r["dtype"] == "f32"}
    out = {}
    for dev, run in runs.items():
        run.dit.load_state_dict(start)
        to = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731

        def steps():
            kept = KeptGradients(TrainState.create(run.dit, TV.adamw(args.teacher_lr, 200, 1.0, torch.bfloat16),
                                                   ema=False))
            loss = TV.teacher_step(kept, run.eps(run.dit), run.sched, x0.to(dev), t.to(dev), noise.to(dev),
                                   y=run.zeros_y(bt))
            run.dit.load_state_dict(start)  # the DMD steps start from the same weights as the teacher step
            teacher = set_compute_dtype(TVP.frozen_bf16(run.dit), torch.float32)
            gen = TVP.load_f32(run.dit, teacher)
            fake = copy.deepcopy(gen)
            gen_state, fake_state = TVP.dmd_states(run, gen, fake, args)
            step = TVP.dmd_step_fn(run, gen, fake, teacher, args)
            metrics, grads = [], {}
            for d in draws:
                grads = {}
                m = step(gen_state, fake_state, to(batch), None, {"y": run.zeros_y(bd)}, draws=to(d), keep_grads=grads)
                metrics.append({k: float(v) for k, v in m.items()})
            return float(loss), kept.grads, metrics, {k: [x.cpu() for x in v] for k, v in grads.items()}

        if dev == "cuda":
            reset_counts()
            out[dev], _ = tally_held({A.flash_attention: (held, "(B, H, Nq, Nk, D, masked, with log-sum-exp)"),
                                      A.flash_dq: (held_bwd, "(B, H, Nq, Nk, D, masked)")}, steps,
                                     "production tool f32 steps at depth 2")
            launches = f32_launches(A.flash_attention.launches, 0, "phase 19, f32 steps at depth 2")
        else:
            out[dev] = steps()
    (l_cpu, tg_cpu, m_cpu, g_cpu), (l_gpu, tg_gpu, m_gpu, g_gpu) = out["cpu"], out["cuda"]
    errs = {"teacher loss": abs(l_gpu - l_cpu) / abs(l_cpu),
            "teacher grad": max((a - b).abs().max().item() for a, b in zip(tg_gpu, tg_cpu))
            / max(b.abs().max().item() for b in tg_cpu)}
    for i, (mc, mg) in enumerate(zip(m_cpu, m_gpu)):
        errs.update({f"dmd step {i + 1} {k}": abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc})
    for which in ("generator", "fake"):
        top = max(x.abs().max().item() for x in g_cpu[which])
        errs[f"dmd step 2 grad {which}"] = max((a - b).abs().max().item() for a, b in zip(g_gpu[which], g_cpu[which])) / top
    print(f"[trainval] one teacher step (batch {bt}) and two DMD steps (batch {bd}) of the production tool at depth 2, "
          f"full width, f32, card against CPU (same weights and draws): CPU loss {l_cpu:.6f}, DMD metrics {m_cpu}; "
          f"relative differences " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (bound {TRAIN_F32_BOUND:.0e}); card launches {launches}", flush=True)
    if m_cpu[1]["dm"] < 1e-8:
        fail("phase 19, card against CPU: the distribution-matching term is not exercised")
    if not max(errs.values()) <= TRAIN_F32_BOUND:
        fail(f"phase 19: the production tool's f32 steps on the card differ from the CPU by {errs}")
    del runs
    return dict(errs, f32_launches=launches)


def trainval_phase(d32_held, attn_records, lse_records, dq_records, dkv_records, conv_records, norm_records, work):
    """Phase 19: the training-validation tools (``trainval_toy``,
    ``trainval_prod``, ``trainval_card_against_cpu``)."""
    import torch

    toy = trainval_toy(d32_held, work)
    torch.cuda.empty_cache()
    prod = trainval_prod(attn_records, lse_records, dq_records, dkv_records, conv_records, norm_records, work)
    torch.cuda.empty_cache()
    return {"toy": toy, "prod": prod, "card_vs_cpu": trainval_card_against_cpu(attn_records, lse_records, dq_records)}


# Phase 20: a gradient through the frozen f32 VAE, the Reflow trainer's LPIPS term (``train/distill.reflow_loss``'s
# ``lpips_fn``) through the decode. Its two runs: configs/cldm.yaml at full width, batch 2 at 512^2; and the twin held
# against the CPU, the UNet and the ControlNet at CLDM_SMALL_NET, the VAE at full width (mid block at 512 channels:
# head dim 512) with one res block a level, batch 2 at 256^2 (1,024 mid-block tokens): (name, VAE override, batch,
# image size)
VAE_GRAD_RUNS = (("full", {}, 2, 512), ("cut", {"num_res_blocks": 1}, 2, 256))
# K2's f32 form at head dim 512 and K1's there with its log-sum-exp: the mid block of both runs' decodes (their
# encodes' forward without the log-sum-exp), and a ragged shape whose second sample has every key masked: (name,
# (B, H, Nq, Nk, D), keys kept per sample or None)
D512_GRAD_CASES = [("vae_mid_decode_b2", (2, 1, 4096, 4096, 512), None),
                   ("vae_mid_decode_cut_b2", (2, 1, 1024, 1024, 512), None),
                   ("ragged_d512_masked", (2, 1, 1000, 333, 512), (199, 0))]
# K5's input gradient on the card (the kernels forward, autograd through the plain composition backward) against
# autograd through the plain composition alone: the same backward on the same saved input, so only the order of
# torch's own reductions could differ; 1e-6 of the reference gradient's largest magnitude. At the full run's
# decode: its AttnBlock.norm (no SiLU) and its norm_out (SiLU)
NORM_GRAD_BOUND = 1e-6
NORM_GRAD_SHAPES = [("decode_b2_attn_norm", (2, 64, 64, 512)), ("decode_b2_norm_out", (2, 512, 512, 128))]


def vae_grad_config(override, section="vae"):
    """configs/cldm.yaml with ``override`` merged into its ``section`` (the whole config for section None)."""
    from instarevive_tpu_torch.config import load_config, merge

    cfg = load_config(os.path.join(REPO, "configs", "cldm.yaml"))
    return merge(cfg, override) if section is None else merge(cfg[section], override)


def vae_kernel_shapes(vae, n, size, encodes, decodes):
    """The shapes a VAE of config ``vae`` gives the kernels in ``encodes`` encodes of n x size^2 images and
    ``decodes`` decodes of their latents (``models/vae.py``): K3's (N, H, W, C, Co), two a ResnetBlock; K5a's (N,
    H, W, C) inside every K3 and at the standalone norms, which K5b applies (AttnBlock.norm and norm_out); K5c's
    (N, H, W, C) before each of the decoder's upsample convs."""
    ch, mult, blocks = vae["ch"], list(vae["ch_mult"]), vae["num_res_blocks"]
    low, mid = size >> (len(mult) - 1), ch * mult[-1]
    conv, norm, up = set(), set(), set()

    def resblock(r, cin, cout):
        conv.update({(n, r, r, cin, cout), (n, r, r, cout, cout)})

    if encodes:
        r, cin = size, ch
        for i, m in enumerate(mult):
            for _ in range(blocks):
                resblock(r, cin, ch * m)
                cin = ch * m
            r = r // 2 if i < len(mult) - 1 else r
        resblock(low, mid, mid)
        norm.add((n, low, low, mid))
    if decodes:
        resblock(low, mid, mid)
        norm.update({(n, low, low, mid), (n, size, size, ch * mult[0])})
        r, cin = low, mid
        for i in reversed(range(len(mult))):
            for _ in range(blocks + 1):
                resblock(r, cin, ch * mult[i])
                cin = ch * mult[i]
            if i:
                up.add((n, r, r, cin))
                r *= 2
    return {"conv": conv, "stats": {s[:4] for s in conv} | norm, "apply": norm, "up": up}


def vae_grad_shapes(kind):
    """Every shape of ``kind`` ("conv", "stats", "apply", "up") that phase 20's runs (two encodes and a decode
    each; for "up" also the frozen SwinIR's upsampler, 64 features from size / 8 up in three steps) give the
    kernels, with the first run's name, sorted."""
    out = {}
    for name, override, n, size in VAE_GRAD_RUNS:
        shapes = vae_kernel_shapes(vae_grad_config(override), n, size, 2, 1)[kind]
        if kind == "up":
            shapes |= {(n, size // f, size // f, 64) for f in (8, 4, 2)}
        for shape in shapes:
            out.setdefault(shape, f"vae_grad_{name}")
    return sorted(out.items())


def vae_grad_kernels():
    """(a) of phase 20: K2's f32 form at head dim 512 (the dq pass; dK and dV in one grid) against
    ``flash_backward_plain``, and K1's f32 form there without and with its log-sum-exp against ``sdpa`` and
    ``flash_lse_plain``, at D512_GRAD_CASES: errors (K2 relative to each output's largest magnitude), the same bits
    twice, the kernels alone on planes made before beside the prepass, the plain versions, the backward of
    ``F.scaled_dot_product_attention`` in f32 (TF32 off) and the bounds; then K5's input gradient at
    NORM_GRAD_SHAPES, with and without the SiLU. Returns (forward records, dq records, dk/dv records, norm gradient
    records)."""
    import torch
    import torch.nn.functional as F

    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.ops.norm_kernels import gn_affine, group_norm_silu, group_norm_silu_plain

    fwd_recs, dq_recs, dkv_recs, norm_recs = [], [], [], []
    gen = torch.Generator(device="cuda").manual_seed(20)
    for name, (b, h, nq, nk, d), kept in D512_GRAD_CASES:
        q, k, do = (torch.randn(b, h, n, d, device="cuda", generator=gen) for n in (nq, nk, nq))
        v = torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1
        mask = None if kept is None else torch.arange(nk, device="cuda")[None] < torch.tensor(kept, device="cuda")[:, None]
        scale, attn_mask = d**-0.5, None if mask is None else mask[:, None, None, :]
        with torch.no_grad():
            o, lse = A._forward(q, k, v, mask, scale, want_lse=True)
            o_without = A._forward(q, k, v, mask, scale, want_lse=False)[0]
            torch.cuda.synchronize()
            ref = A.sdpa(q, k, v, kv_mask=mask, scale=scale)
            ref_max = ref.abs().max().item()
            o_err, lse_err = max_err(o, ref), max_err(lse, A.flash_lse_plain(q, k, mask, scale))
            dead = [i for i, n_kept in enumerate(kept or ()) if n_kept == 0]
            flags = all(bool((lse[i] == A.NEG_INF).all()) for i in dead)
            got = A.flash_backward(q, k, v, mask, o, lse, do, scale)
            torch.cuda.synchronize()
            want = A.flash_backward_plain(q, k, v, mask, o, lse, do, scale)
            rel, abs_errs = {}, {}
            for key, x, y in zip(("dq", "dk", "dv"), got, want):
                if not torch.isfinite(x).all():
                    fail(f"phase 20, head dim 512 {name}: {key} is not finite")
                abs_errs[key] = max_err(x, y)
                rel[key] = abs_errs[key] / y.abs().max().item()
            same = torch.equal(o, o_without) and all(
                torch.equal(x, y) for x, y in zip(got, A.flash_backward(q, k, v, mask, o, lse, do, scale)))
            di, planes = (do * o).sum(-1), A.backward_planes(q, k, v, do)  # the kernels alone: planes made before
            ms_fwd = cuda_ms(lambda: A._forward(q, k, v, mask, scale, want_lse=False), iters=10)
            ms_lse = cuda_ms(lambda: A._forward(q, k, v, mask, scale, want_lse=True), iters=10)
            ms_dq = cuda_ms(lambda: A.flash_dq(q, k, v, mask, lse, di, do, scale, planes), iters=10)
            ms_dkv = cuda_ms(lambda: A.flash_dkv(q, k, v, mask, lse, di, do, scale, planes), iters=10)
            ms_both = cuda_ms(lambda: A.flash_backward(q, k, v, mask, o, lse, do, scale), iters=10)
            ms_prepass = cuda_ms(lambda: A.backward_planes(q, k, v, do), iters=10)
            plain_fwd_ms = cuda_ms(lambda: A.sdpa(q, k, v, kv_mask=mask, scale=scale), iters=3, warmup=1)
            plain_lse_ms = cuda_ms(lambda: A.flash_lse_plain(q, k, mask, scale), iters=3, warmup=1)
            plain_ms = cuda_ms(lambda: A.flash_backward_plain(q, k, v, mask, o, lse, do, scale), iters=3, warmup=1)
            lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), iters=10)
            del planes
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), iters=10)
        del lib_out, leaves
        pairs = float(h * nq * (b * nk if mask is None else int(mask.sum().item())))  # masked keys take no product
        es = q.element_size()
        b_fwd = bound(es * (2 * q.numel() + 2 * k.numel()), 4.0 * pairs * d, "f32", True)
        b_lse = bound(es * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel(), 4.0 * pairs * d, "f32", True)
        b_dq = bound(es * (3 * q.numel() + 2 * k.numel()) + 8 * lse.numel(), 6.0 * pairs * d, "f32", True)
        b_dkv = bound(es * (2 * q.numel() + 4 * k.numel()) + 8 * lse.numel(), 8.0 * pairs * d, "f32", True)
        b_both = bound(es * (4 * q.numel() + 4 * k.numel()), 10.0 * pairs * d, "f32", True)
        bnd, limit = BACKWARD_BOUNDS["f32"], min(BOUNDS["f32"], REL_BOUNDS["f32"] * ref_max)
        common = dict(name=name, dtype="f32", shape=[b, h, nq, nk, d], masked=mask is not None, bitwise_repeat=same)
        fwd_recs.append(dict(common, max_abs_err=o_err, ref_max_abs=ref_max, bound=limit, lse_max_abs_err=lse_err,
                             lse_bound=LSE_BOUNDS["f32"], ms=ms_fwd, ms_with_lse=ms_lse, plain_ms=plain_fwd_ms,
                             plain_lse_ms=plain_lse_ms, library_ms=lib_fwd_ms, bound_ms=b_fwd[0], bound_by=b_fwd[1],
                             bound_with_lse_ms=b_lse[0]))
        back = dict(common, bound=bnd, plain_ms=plain_ms, library_ms=lib_ms, together_ms=ms_both,
                    together_bound_ms=b_both[0], prepass_ms=ms_prepass)
        dq_recs.append(dict(back, max_abs_err=abs_errs["dq"], max_rel_err=rel["dq"], ms=ms_dq, bound_ms=b_dq[0],
                            bound_by=b_dq[1]))
        dkv_recs.append(dict(back, max_abs_err=max(abs_errs["dk"], abs_errs["dv"]), max_rel_err=max(rel["dk"], rel["dv"]),
                             rel_err={k: rel[k] for k in ("dk", "dv")}, ms=ms_dkv, bound_ms=b_dkv[0], bound_by=b_dkv[1]))
        print(f"[vae_grad] {name:22s} f32 B,H,Nq,Nk,D={b},{h},{nq},{nk},{d} mask={mask is not None!s:5s} K1 "
              f"max_abs_err={o_err:.3e} (bound {limit:.1e}) lse={lse_err:.3e} (bound {LSE_BOUNDS['f32']:.0e}"
              f"{', -1e30 where no key' if dead else ''}); K2 rel_err dq={rel['dq']:.3e} dk={rel['dk']:.3e} "
              f"dv={rel['dv']:.3e} (bound {bnd:.0e}); same bits twice={same} | ms, kernels alone: fwd={ms_fwd:.4f} "
              f"with_lse={ms_lse:.4f} (bound {b_fwd[0]:.4f}, {b_fwd[1]}) dq={ms_dq:.4f} (bound {b_dq[0]:.4f}) "
              f"dkv={ms_dkv:.4f} (bound {b_dkv[0]:.4f}); prepass={ms_prepass:.4f}; dq+dkv+di with the prepass "
              f"{ms_both:.4f} (bound {b_both[0]:.4f}) | plain fwd={plain_fwd_ms:.4f} lse={plain_lse_ms:.4f} "
              f"bwd={plain_ms:.4f} | torch sdpa f32 fwd={lib_fwd_ms:.4f} bwd={lib_ms:.4f}", flush=True)
        if not (o_err <= limit and lse_err <= LSE_BOUNDS["f32"] and flags and max(rel.values()) <= bnd):
            fail(f"phase 20, head dim 512 {name}: output {o_err}, lse {lse_err} (flags {flags}), gradients {rel}")
        if not same:
            fail(f"phase 20, head dim 512 {name}: two runs on the same inputs differ")
        del q, k, v, do, o, o_without, lse, ref, got, want, di

    for name, (n, h, w, c) in NORM_GRAD_SHAPES:
        x, gamma, beta = vae_inputs(gen, "f32", n, h, w, c)
        cot = torch.randn(n, h, w, c, device="cuda", generator=gen)
        leaf = x.clone().requires_grad_(True)
        for silu in (True, False):
            before = (gn_affine.launches, group_norm_silu.launches)
            out = group_norm_silu(leaf, gamma, beta, silu=silu)
            launched = (gn_affine.launches - before[0], group_norm_silu.launches - before[1])
            with torch.no_grad():
                same_fwd = torch.equal(out, group_norm_silu(x, gamma, beta, silu=silu))
            (got,) = torch.autograd.grad(out, leaf, cot)
            (want,) = torch.autograd.grad(group_norm_silu_plain(leaf, gamma, beta, silu=silu), leaf, cot)
            err = max_err(got, want) / want.abs().max().item()
            same = torch.equal(got, torch.autograd.grad(group_norm_silu(leaf, gamma, beta, silu=silu), leaf, cot)[0])
            x_cl, gl, bl = leaf.permute(0, 3, 1, 2), gamma.clone(), beta.clone()

            def library():
                y = F.group_norm(x_cl, 32, gl, bl, 1e-6)
                return torch.autograd.grad(F.silu(y) if silu else y, leaf, cot.permute(0, 3, 1, 2))

            fwd_ms = cuda_ms(lambda: group_norm_silu(leaf, gamma, beta, silu=silu))
            both_ms = cuda_ms(lambda: torch.autograd.grad(group_norm_silu(leaf, gamma, beta, silu=silu), leaf, cot))
            plain_ms = cuda_ms(lambda: torch.autograd.grad(group_norm_silu_plain(leaf, gamma, beta, silu=silu), leaf,
                                                           cot), iters=3, warmup=1)
            lib_ms = cuda_ms(library)
            # forward: x read, y written; backward: x and the cotangent read, dx written
            b_ms, b_by = bound(5 * 4 * x.numel(), 0.0, "f32")
            rec = dict(name=name, dtype="f32", shape=[n, h, w, c], silu=silu, max_rel_err=err, bound=NORM_GRAD_BOUND,
                       forward_launches=launched, forward_bits_as_without_grad=same_fwd, bitwise_repeat=same,
                       forward_ms=fwd_ms, ms=both_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            print(f"[vae_grad] K5 input gradient {name:20s} f32 N,H,W,C={n},{h},{w},{c} silu={silu!s:5s} "
                  f"rel_err={err:.2e} (bound {NORM_GRAD_BOUND:.0e}) forward launches (moments, apply) {launched}, "
                  f"the bits of a call without grad={same_fwd}, same gradient twice={same} | ms: kernels forward "
                  f"{fwd_ms:.4f}, forward + plain backward {both_ms:.4f}; plain forward + backward {plain_ms:.4f}; "
                  f"F.group_norm{' + F.silu' if silu else ''} forward + backward {lib_ms:.4f}; bound {b_ms:.4f} "
                  f"({b_by})", flush=True)
            if not (err <= NORM_GRAD_BOUND and launched == (1, 1) and same_fwd and same):
                fail(f"phase 20, K5 input gradient {name} silu={silu}: {rec}")
            norm_recs.append(rec)
        del x, leaf, cot, out, got, want
    return fwd_recs, dq_recs, dkv_recs, norm_recs


def seeded_lpips(device):
    """LPIPS (AlexNet) from the seeded official-layout dicts of ``tools/iqa_checkpoints`` (phase 16's), frozen."""
    from instarevive_tpu_torch.tools import iqa_checkpoints
    from instarevive_tpu_torch.utils.metrics import LPIPS, lpips_state_dict

    net = LPIPS()
    net.load_state_dict(lpips_state_dict(*iqa_checkpoints.lpips(0)))
    return net.to(device).requires_grad_(False)


def reflow_lpips_step(task, pair, lpips, draws=None, keep_grads=None):
    """One Reflow step of ``task`` (a ``train.launcher.CLDMTask`` for ``--task reflow``) with the LPIPS term:
    ``distill.reflow_loss`` with the cldm task's ``apply_model`` and ``lpips_fn(z, hq) = LPIPS(decode(z /
    0.18215), hq).mean()`` through the frozen VAE, weight 0.1, the gradient into the trained parameters, then the
    optimizer through ``nan_guard``. ``draws``: {"t", "z_T"} in place of the task's generator. Returns the step's
    metrics (loss, reflow_mse, lpips, grads_finite, the gradient's norm)."""
    import torch

    from instarevive_tpu_torch.train import distill
    from instarevive_tpu_torch.train.cldm import SCALE_FACTOR
    from instarevive_tpu_torch.utils.debug import nan_guard

    state, _ = task.states
    z0, c_latent = task.task.get_input({"hq": pair["hq"], "lq": pair["lq"], "context": task.context})

    def lpips_fn(z, hq):
        return lpips(task.pipe.vae.decode(z / SCALE_FACTOR), hq).mean()

    loss, metrics = distill.reflow_loss(
        task.pipe.sched, lambda z, t, context, c_latent: task.task.apply_model(z, t, context, c_latent), z0,
        task.generator, {"context": task.context, "c_latent": c_latent}, lpips_fn=lpips_fn, hq=pair["hq"],
        **(draws or {}))
    grads = state.gradients(loss)
    out = {"loss": loss.detach(), **metrics,
           "grad_norm": torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))}
    nan_guard(state, grads, out)
    if keep_grads is not None:
        keep_grads.extend(g.detach() for g in grads)
    return out


def vae_grad_held(fwd_recs, dq_recs, dkv_recs, held64, conv_records, norm_records, swin_records):
    """The shapes the kernel phases held for phase 20's f32 runs: {wrapper: (held keys, legend, which tallied
    shapes must be held)}. K1 and K2 at head dim 512 from ``vae_grad_kernels``, at 64 from ``d64_phase``
    (``held64``: bf16 and f32 alike; the cut run's small UNet is counted, not held, as phase 12's f32 step);
    K3, K4, K5 in f32 from their phases."""
    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3
    from instarevive_tpu_torch.ops.norm_kernels import gn_affine, group_norm_silu, upsample2x_nearest
    from instarevive_tpu_torch.ops.swin_attention import swin_window_attention

    stats_records, apply_records, up_records = norm_records
    f32 = lambda recs: {(*r["shape"], "f32") for r in recs if r["dtype"] == "f32"}  # noqa: E731
    at512 = lambda shape: shape[4] == 512  # noqa: E731
    keys = {(*r["shape"], r["masked"]) for r in fwd_recs}
    return {A.flash_attention: ({(*key, lse) for key in keys | held64 for lse in (False, True)},
                                "(B, H, Nq, Nk, D, masked, with log-sum-exp)", at512),
            A.flash_dq: ({(*r["shape"], r["masked"]) for r in dq_recs} | held64, "(B, H, Nq, Nk, D, masked)", at512),
            A.flash_dkv: ({(*r["shape"], r["masked"]) for r in dkv_recs} | held64, "(B, H, Nq, Nk, D, masked)", at512),
            gn_silu_conv3x3: (f32(conv_records), "(N, H, W, C, Co, dtype)"),
            gn_affine: (f32(stats_records), "(N, H, W, C, dtype)"),
            group_norm_silu: (f32(apply_records), "(N, H, W, C, dtype)"),
            upsample2x_nearest: (f32(up_records), "(N, H, W, C, dtype)"),
            swin_window_attention: ({(*r["shape"], r["shift"], r["masked"]) for r in swin_records if r["dtype"] == "f32"},
                                    "(B, H, W, 3C, shift, masked)")}


def vae_grad_expected(cfg, n, size, first):
    """Every kernel's launches in one ``reflow_lpips_step`` of a task of ``cfg`` on n x size^2 pairs: a cldm
    step's (``time_train.cldm_expected_launches``: two frozen encodes, the SwinIR, the UNet and the ControlNet),
    plus the decode under the gradient (its K3s, two standalone norms, levels - 1 upsamples, K1 at head dim 512
    with its log-sum-exp, K2's dq and dk/dv there once each); the prepass as ``f32_launches`` reckons it, packing
    every K3 conv's weight planes in the ``first`` step. Returns (launch counts, head-dim-512 launches by kind,
    f32_launches' arguments)."""
    from instarevive_tpu_torch.tools import time_train as T

    want = dict(T.cldm_expected_launches(cfg))
    levels, blocks = len(cfg["vae"]["ch_mult"]), cfg["vae"]["num_res_blocks"]
    enc, dec = 2 * (levels * blocks + 2), 2 * (levels * (blocks + 1) + 2)  # K3 launches of an encode, a decode
    want.update(flash_attn_fwd=want["flash_attn_fwd"] + 1, flash_attn_bwd_dq=want["flash_attn_bwd_dq"] + 1,
                flash_attn_bwd_dkv=want["flash_attn_bwd_dkv"] + 1, gn_silu_conv3x3=2 * enc + dec,
                gn_stats_fold=2 * (enc + 2) + dec + 2, gn_apply=6, upsample2x=want["upsample2x"] + levels - 1)
    attn = T.cldm_attention_counts(cfg)
    d512 = {"fwd": 2, "fwd_with_lse": 1, "dq": 1, "dkv": 1}
    return want, d512, dict(fwd_split=attn["d64"], fwd_d512=3, convs=2 * enc + dec, conv_modules=enc + dec if first else 0)


def d512_tally(shapes):
    """Head-dim-512 launches by kind from ``tally_held``'s tallies."""
    fwd = shapes["flash_attention"]
    return {"fwd": sum(v for k, v in fwd.items() if k[4] == 512 and not k[6]),
            "fwd_with_lse": sum(v for k, v in fwd.items() if k[4] == 512 and k[6]),
            "dq": sum(v for k, v in shapes["flash_dq"].items() if k[4] == 512),
            "dkv": sum(v for k, v in shapes["flash_dkv"].items() if k[4] == 512)}


def vae_grad_full(held):
    """(b) of phase 20: configs/cldm.yaml at full width in f32 (UNet, ControlNet, the frozen SwinIR and VAE, the
    trainer's own ``CLDMTask`` for ``--task reflow``), batch 2 at 512^2: two Reflow steps with the LPIPS term
    through the frozen VAE decode (``reflow_lpips_step``), each backward to the trained parameters and then the
    optimizer. Every loss, metric and gradient norm finite; every kernel's launches as the configuration implies
    (K1 at head dim 512 with its log-sum-exp once a step and K2's dq and dk/dv there once each, beside the two
    encodes' K1), every shape held; walls, peak memory. Returns its record."""
    import gc
    import math

    import torch

    from instarevive_tpu_torch.tools import time_train as T
    from instarevive_tpu_torch.train import launcher

    config = os.path.join(REPO, "configs", "cldm.yaml")
    cfg = vae_grad_config({}, None)
    args = launcher.parse_args(T.train_argv(config, "-", "-", 1, task="reflow", bf16=False))
    t0 = time.perf_counter()
    task = launcher.CLDMTask(args, cfg, torch.device("cuda"))
    task.pipe.requires_grad_(False)
    lpips = seeded_lpips("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        batch = T.load_batches(T.write_images(os.path.join(tmp, "hq"), n=T.BATCH), 1)[0]
    pair = task.degrade(torch.from_numpy(batch["hq"]).to("cuda").float() / 255.0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state = task.states[0]
    before = dict(task.model.named_parameters())["unet.out.2.weight"].detach().clone()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(2):
        reset_counts()
        t0 = time.perf_counter()
        m, shapes = tally_held(held, lambda: reflow_lpips_step(task, pair, lpips), f"phase 20, full-width step {i}")
        wall = time.perf_counter() - t0
        metrics = {k: float(v) for k, v in m.items()}
        want, want512, f32_args = vae_grad_expected(cfg, T.BATCH, T.CROP, first=i == 0)
        got, got512 = read_counts(), d512_tally(shapes)
        launches = f32_launches(f32_args["fwd_split"], f32_args["fwd_d512"], f"phase 20, full-width step {i}",
                                convs=f32_args["convs"], conv_modules=f32_args["conv_modules"])
        steps.append(dict(wall_s=wall, metrics=metrics, launches=got, d512=got512, f32_launches=launches))
        print(f"[vae_grad] {card_line()}: configs/cldm.yaml at full width in f32, batch {T.BATCH} at {T.CROP}^2, "
              f"Reflow step {i} with the LPIPS term through the frozen VAE decode (weight 0.1): wall {wall:.3f} s; "
              f"metrics {({k: round(v, 6) for k, v in metrics.items()})}; launches {got}; at head dim 512 {got512}",
              flush=True)
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["grads_finite"] != 1.0 \
                or not metrics["grad_norm"] > 0 or not metrics["lpips"] > 0:
            fail(f"phase 20, full-width step {i}: metrics {metrics}")
        if got != dict(want, filter2d=0) or got512 != want512:
            fail(f"phase 20, full-width step {i}: launches {got} (head dim 512: {got512}), expected {want} ({want512})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = not torch.equal(dict(task.model.named_parameters())["unet.out.2.weight"].detach(), before)
    if int(state.step) != 2 or not moved:
        fail(f"phase 20: the optimizer took {int(state.step)} steps; the UNet's last conv moved: {moved}")
    print(f"[vae_grad] full width: set-up {build_s:.1f} s (models, LPIPS, one degraded batch); walls "
          f"{[round(s['wall_s'], 3) for s in steps]} s (the first packs every K3 weight's planes); peak allocated "
          f"{peak:.2f} GiB; the optimizer took 2 steps", flush=True)
    del task, pair, lpips
    gc.collect()
    torch.cuda.empty_cache()
    return dict(config="configs/cldm.yaml", batch=T.BATCH, size=T.CROP, setup_s=build_s, steps=steps, peak_gib=peak)


def vae_grad_card_against_cpu(held):
    """(c) of phase 20: one Reflow step with the LPIPS term of the cut run (VAE_GRAD_RUNS "cut": UNet and
    ControlNet at CLDM_SMALL_NET, every layer random; the VAE at full width with one res block a level, so the mid
    block's attention is at head dim 512 over 1,024 tokens; the SwinIR at full width) on the card and on the CPU:
    the same weights, pair and draws; the loss, the LPIPS term and every gradient within CLDM_F32_BOUND; on the card
    K1 at 512 with its log-sum-exp once and K2 there once each, every head-dim-512, K3, K4 and K5 shape held.
    Returns its record."""
    import torch

    from instarevive_tpu_torch.pipelines.build import init_params
    from instarevive_tpu_torch.tools import time_train as T
    from instarevive_tpu_torch.train import launcher

    (_, override, n, size), = [run for run in VAE_GRAD_RUNS if run[0] == "cut"]
    cfg = vae_grad_config({"unet": CLDM_SMALL_NET, "controlnet": CLDM_SMALL_NET, "vae": override}, None)
    args = launcher.parse_args(T.train_argv("-", "-", "-", 1, task="reflow", bf16=False))
    cpu, gpu = launcher.CLDMTask(args, cfg, torch.device("cpu")), launcher.CLDMTask(args, cfg, torch.device("cuda"))
    init_params(cpu.model, seed=3)
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.pipe.load_state_dict(cpu.pipe.state_dict())
    gen = torch.Generator().manual_seed(25)
    pair = {"hq": torch.rand(n, size, size, 3, generator=gen) * 2 - 1, "lq": torch.rand(n, size, size, 3, generator=gen)}
    draws = {"t": torch.tensor([17, 803]), "z_T": torch.randn(n, size // 8, size // 8, 4, generator=gen)}
    res, walls = {}, {}
    for label, task in (("cpu", cpu), ("cuda", gpu)):
        task.pipe.requires_grad_(False)
        lpips, kept = seeded_lpips(task.device), []
        on = {k: v.to(task.device) for k, v in pair.items()}

        def step():
            return reflow_lpips_step(task, on, lpips, {k: v.to(task.device) for k, v in draws.items()}, kept)

        reset_counts()
        t0 = time.perf_counter()
        if label == "cuda":
            m, shapes = tally_held(held, step, "phase 20, cut step on the card")
        else:
            m = step()
        walls[label] = time.perf_counter() - t0
        res[label] = ({k: float(v) for k, v in m.items()}, [g.cpu() for g in kept])
    want, want512, f32_args = vae_grad_expected(cfg, n, size, first=True)
    got512 = d512_tally(shapes)
    launches = f32_launches(f32_args["fwd_split"], f32_args["fwd_d512"], "phase 20, cut step on the card",
                            convs=f32_args["convs"], conv_modules=f32_args["conv_modules"])
    if got512 != want512 or {k: v for k, v in read_counts().items() if k != "filter2d"} != \
            {k: v for k, v in want.items() if k != "filter2d"}:
        fail(f"phase 20, cut step on the card: launches {read_counts()} (head dim 512: {got512}), expected {want} "
             f"({want512})")
    (m_cpu, g_cpu), (m_gpu, g_gpu) = res["cpu"], res["cuda"]
    top = max(g.abs().max().item() for g in g_cpu)
    errs = {"loss": abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"]),
            "lpips": abs(m_gpu["lpips"] - m_cpu["lpips"]) / abs(m_cpu["lpips"]),
            "grad": max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu)) / top}
    print(f"[vae_grad] the cut step (UNet and ControlNet at {CLDM_SMALL_NET}, every layer random; VAE one res block "
          f"a level, mid block at head dim 512 over {(size // 8) ** 2} tokens; {n} x {size}^2) on the card against the "
          f"CPU, the same weights, pair and draws: CPU {({k: round(v, 6) for k, v in m_cpu.items()})}; relative "
          f"differences " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (bound {CLDM_F32_BOUND:.0e}); "
          f"walls card {walls['cuda']:.2f} s, CPU {walls['cpu']:.2f} s; at head dim 512 {got512}; f32 launches "
          f"{launches}", flush=True)
    if not max(errs.values()) <= CLDM_F32_BOUND or m_gpu["grads_finite"] != 1.0:
        fail(f"phase 20, cut step: the card differs from the CPU by {errs}")
    return dict(errs, walls_s=walls, d512=got512, f32_launches=launches, cpu_metrics=m_cpu, card_metrics=m_gpu)


def vae_grad_phase(held64, conv_records, norm_records, swin_records):
    """Phase 20: a gradient through the frozen f32 VAE (``vae_grad_kernels``, ``vae_grad_full``,
    ``vae_grad_card_against_cpu``). Returns (the kernels' records, the phase's record)."""
    import torch

    t0 = time.perf_counter()
    fwd_recs, dq_recs, dkv_recs, norm_grad = vae_grad_kernels()
    torch.cuda.empty_cache()
    held = vae_grad_held(fwd_recs, dq_recs, dkv_recs, held64, conv_records, norm_records, swin_records)
    kernels_s = time.perf_counter() - t0
    full = vae_grad_full({fn: entry[:2] for fn, entry in held.items()})  # at full width every shape is held
    card_vs_cpu = vae_grad_card_against_cpu(held)
    rec = {"kernels_s": kernels_s, "full": full, "card_vs_cpu": card_vs_cpu, "norm_gradient": norm_grad,
           "phase_s": time.perf_counter() - t0}
    print(f"[vae_grad] phase 20 wall {rec['phase_s']:.1f} s (kernel checks {kernels_s:.1f} s)", flush=True)
    return (fwd_recs, dq_recs, dkv_recs), rec


def d512_grad_entries(fwd_recs, dq_recs, dkv_recs, vae_grad, bwd_build):
    """K2's f32 form at head dim 512 in the ``kernels`` line, one entry a pass: the full-width decode's shape at
    top level, every phase-20 shape below; ``launches`` is phase 20's full-width run (two Reflow steps with the
    LPIPS term), the cut step's beside; each carries its kernel's build figures."""
    out = []
    for name, key, replaces, records in (
            ("flash_attn_bwd_dq_f32_d512", "dq", "instarevive_tpu/ops/attention.py:127", dq_recs),
            ("flash_attn_bwd_dkv_f32_d512", "dkv", "instarevive_tpu/ops/attention.py:166", dkv_recs)):
        main_rec = next(r for r in records if r["name"] == "vae_mid_decode_b2")
        out.append({
            "name": name, "route": "cuda", "source": "instarevive_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": replaces, "form": "bwd512_tf32",
            "launches": sum(step["d512"][key] for step in vae_grad["full"]["steps"]),
            "launches_per_full_step": vae_grad["full"]["steps"][-1]["d512"][key],
            "launches_cut_step": vae_grad["card_vs_cpu"]["d512"][key],
            "max_abs_err": max(r["max_abs_err"] for r in records), "max_rel_err": max(r["max_rel_err"] for r in records),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"], "main_shape": main_rec["shape"],
            "shapes": records,
            "build": {k: v for k, v in bwd_build.items() if k.startswith((f"f32_{key}_d512", "f32_d512"))}})
    return out


def d32_entries(fwd_records, dq_records, dkv_records, toy, fwd_build, bwd_build):
    """K1's and K2's f32 forms at head dim 32 in the ``kernels`` line: the
    toy's self-attention at top level, every head-dim-32 shape below;
    ``launches`` is the toy tool's run in phase 19 (by stage beside)."""
    out = []
    for name, key, replaces, records, build in (
            ("flash_attn_fwd_f32_d32", "flash_attn_fwd", "instarevive_tpu/ops/attention.py:63", fwd_records,
             {k: v for k, v in fwd_build.items() if k.startswith("f32_d32")}),
            ("flash_attn_bwd_dq_f32_d32", "flash_attn_bwd_dq", "instarevive_tpu/ops/attention.py:127", dq_records,
             {k: v for k, v in bwd_build.items() if k.startswith(("f32_dq_d32", "f32_d32"))}),
            ("flash_attn_bwd_dkv_f32_d32", "flash_attn_bwd_dkv", "instarevive_tpu/ops/attention.py:166", dkv_records,
             {k: v for k, v in bwd_build.items() if k.startswith(("f32_dkv_d32", "f32_d32"))})):
        main_rec = next(r for r in records if r["name"] == "toy_self")
        entry = {"name": name, "route": "cuda",
                 "source": "instarevive_tpu_torch/csrc/" + ("flash_attn_fwd.cu" if "fwd" in name else "flash_attn_bwd.cu"),
                 "replaces": replaces, "launches": toy["launches"][key],
                 "launches_toy_by_stage": {stage: c[key] for stage, c in toy["launches_by_stage"].items()},
                 "max_abs_err": max(r["max_abs_err"] for r in records), "max_rel_err": max(r["max_rel_err"] for r in records),
                 "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
                 "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"], "main_shape": main_rec["shape"],
                 "shapes": records, "build": build}
        if name == "flash_attn_fwd_f32_d32":
            entry.update(ms_with_lse=main_rec["ms_with_lse"], bound_with_lse_ms=main_rec["bound_with_lse_ms"],
                         lse_max_abs_err=max(r["lse_max_abs_err"] for r in records))
        out.append(entry)
    return out


def bwd_pass(build, pass_name, form=""):
    """One backward pass's part of ``bwd_build_report``: its registers,
    spills, shared memory and blocks an SM at each head dim, and the form's
    instruction counts, which both passes share (form "": bf16; "f32_")."""
    return {k: v for k, v in build.items()
            if k.startswith(form + pass_name + "_") or k in (form + "HGMMA", form + "UTMALDG", form + "HMMA")}


def d64_entries(fwd_records, dq_records, dkv_records, by_dim, bwd_build):
    """The head-dim-64 instantiations' entries of the ``kernels`` line: the
    UNet's largest self-attention (ds 1) at top level, every shape below;
    ``launches`` is the 3-step ``--task cldm`` run's count from the shape
    tally; the backward's entries carry their pass's build figures."""
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
        else:
            entry["build"] = bwd_pass(bwd_build, "dq" if "_dq_" in name else "dkv")
        out.append(entry)
    return out


def d512_entry(records, build):
    """K1's head-dim-512 form's entry of the ``kernels`` line: the VAE mid
    block in ``process`` at top level, every head-dim-512 shape below;
    ``launches`` is the ``process`` run's count from the shape tally,
    ``launches_tiled`` the tiled call's."""
    recs = [r for r in records if r["dtype"] == "bf16" and r["shape"][4] == 512]
    main_rec = next(r for r in recs if r["name"] == "vae_mid")
    return {
        "name": "flash_attn_fwd_d512", "route": "cuda", "source": "instarevive_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "instarevive_tpu/ops/attention.py:63", "launches": sum(r["launches_process"] for r in recs),
        "launches_tiled": sum(r["launches_tiled"] for r in recs), "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"], "main_shape": main_rec["shape"],
        "shapes": recs, "build": {k: v for k, v in build.items() if k.startswith("d512")},
    }


def f32_entries(attn_records, dq_records, dkv_records, d64, planes_records, fwd_build, bwd_build, f32_steps,
                conv_records, conv_build, conv_grads):
    """The f32 forms' entries of the ``kernels`` line: K1 and K2 on split-tf32
    products at head dims 64 and 72 (the DiT's self-attention at a DMD step's
    batch at top level, every f32 shape at 64 and 72 below), K1's f32 form at
    head dim 512 (the DMD step's VAE encode at top level, with sdpa's error
    in plain TF32 beside, and the ragged masked shape below), K3's f32 form
    on split-tf32 products ((4, 64, 64, 512, 512) at top level, the conv
    alone, cuDNN's conv alone, the prepass and the bound at the f32 FMA rate
    beside; every f32 shape below; the gradient check) and the split prepass.
    Each entry carries its kernels' build figures. ``launches`` is the sum
    over the two f32 card-against-CPU train steps (``f32_steps``: the DMD
    step at depth 2 and the cldm step), each beside."""
    d64_fwd, d64_dq, d64_dkv = d64

    def entry(name, source, replaces, records, main_name, **extra):
        main_rec = next(r for r in records if r["name"] == main_name)
        launches = {step: counts[name] for step, counts in f32_steps.items()}
        return {"name": name, "route": "cuda", "source": f"instarevive_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": sum(launches.values()), **{f"launches_{k}": v for k, v in launches.items()},
                "max_abs_err": max(r["max_abs_err"] for r in records), "ms": main_rec["ms"],
                "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
                "library_ms": main_rec["library_ms"], "main_shape": main_rec["shape"], "shapes": records, **extra}

    split = lambda recs: [r for r in recs if r["dtype"] == "f32" and r["shape"][4] in (64, 72)]  # noqa: E731
    rel = lambda recs: {"max_rel_err": max(r["max_rel_err"] for r in recs)}  # noqa: E731
    fwd = split(attn_records) + split(d64_fwd)
    dq, dkv = split(dq_records) + split(d64_dq), split(dkv_records) + split(d64_dkv)
    d512 = [r for r in attn_records if r["dtype"] == "f32" and r["shape"][4] == 512]
    d512_main = next(r for r in d512 if r["name"] == "vae_mid_dmd_encode")
    conv32 = [r for r in conv_records if r["dtype"] == "f32"]
    conv_main = next(r for r in conv32 if r["name"] == "b4_64_512_512")
    return [
        entry("flash_attn_fwd_f32", "flash_attn_fwd.cu", "instarevive_tpu/ops/attention.py:63", fwd, "dit_self",
              build={k: v for k, v in fwd_build.items() if k.startswith("f32") and not k.startswith("f32_d512")}),
        entry("flash_attn_fwd_f32_d512", "flash_attn_fwd.cu", "instarevive_tpu/ops/attention.py:63", d512,
              "vae_mid_dmd_encode", build={k: v for k, v in fwd_build.items() if k.startswith("f32_d512")},
              max_rel_err=max(r["max_abs_err"] / r["ref_max_abs"] for r in d512),
              tf32_sdpa_max_abs_err=d512_main["tf32_sdpa_max_abs_err"],
              bound_used=min(BOUNDS["f32"], REL_BOUNDS["f32"] * d512_main["ref_max_abs"])),
        entry("flash_attn_bwd_dq_f32", "flash_attn_bwd.cu", "instarevive_tpu/ops/attention.py:127", dq, "dit_self",
              build=bwd_pass(bwd_build, "dq", "f32_"), **rel(dq)),
        entry("flash_attn_bwd_dkv_f32", "flash_attn_bwd.cu", "instarevive_tpu/ops/attention.py:166", dkv, "dit_self",
              build=bwd_pass(bwd_build, "dkv", "f32_"), **rel(dkv)),
        entry("gn_silu_conv3x3_f32", "gn_conv.cu", "instarevive_tpu/ops/gn_conv.py:112", conv32,
              "b4_64_512_512", build={k: v for k, v in conv_build.items() if k.startswith("f32_")},
              gradient=conv_grads, **{k: conv_main[k] for k in ("includes", "conv_only_ms", "conv_library_ms",
                                                                "prepass_ms", "bound_fma_ms")},
              launches_small_pipeline=sum(r.get("launches_small_pipeline", 0) for r in conv32),
              launches_serve=sum(r.get("launches_serve", 0) for r in conv32)),
        entry("tf32_planes", "tf32_planes.cu", "instarevive_tpu/ops/attention.py:63", planes_records, "dit_q_b2",
              note="no TPU kernel of its own: the split of the f32 operands that the f32 forms of K1 "
                   "(attention.py:63), K2 (:127, :166) and K3 (gn_conv.py:112, conv weights once per module) read"),
    ]


def swin_f32_entry(records, build, step_launches):
    """K4's f32 form (``swin_tf32``, split-tf32 products) in the ``kernels``
    line: the f32 records, ``process``'s shifted shape at top level;
    ``launches`` is the count of the depth-cut f32 SwinIR train step held
    against the CPU."""
    f32 = [r for r in records if r["dtype"] == "f32"]
    main_rec = next(r for r in f32 if r["name"] == "process_b4_64x64_shifted")
    return {
        "name": "swin_window_attention_f32", "route": "cuda", "source": "instarevive_tpu_torch/csrc/swin_attention.cu",
        "replaces": "instarevive_tpu/ops/swin_attention.py:48", "form": "swin_tf32",
        "launches": step_launches["swin_window_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in f32), "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
        "library_composition_ms": main_rec["library_composition_ms"], "main_shape": main_rec["shape"],
        "build": {k[4:]: v for k, v in build.items() if k.startswith("f32_")}, "shapes": f32,
    }


def filter_entry(records, swinir_counts, dmd_counts, degrade_launches, build):
    """K6's entry of the ``kernels`` line: f32, the stage-1 blur's times,
    plan and share of the bound at top level, the build report beside;
    ``launches`` is the count of the 3-step ``--task swinir`` run."""
    main_rec = next(r for r in records if r["name"] == "realesrgan_hq_b2_512")
    return {
        "name": "filter2d", "route": "cuda", "source": "instarevive_tpu_torch/csrc/filter2d.cu",
        "replaces": "instarevive_tpu/ops/filters.py:106", "launches": swinir_counts["filter2d"], "launches_tiled": 0,
        "launches_swinir_train_run": swinir_counts["filter2d"], "launches_train_run": dmd_counts["filter2d"],
        "launches_degrade": degrade_launches, "max_abs_err": max(r["max_abs_err"] for r in records),
        "max_rel_err": max(r["max_rel_err"] for r in records),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"],
        "share_of_bound": main_rec["share_of_bound"], "plan": main_rec["plan"],
        "form": "register tiles of rows x 12 flats, two warp groups over a tile's input rows, a block a tile on cp.async",
        "library": "reflect F.pad + one grouped F.conv2d: the plain version itself", "main_shape": main_rec["shape"],
        "build": build, "shapes": records,
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
    for key in ("includes", "conv_only_ms", "conv_library_ms", "library_composition_ms", "max_abs_err_vs_f32"):
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
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params, set_precision

    start, phase_s, mark = time.perf_counter(), {}, [time.perf_counter()]

    def lap(name):  # seconds of the phase that just ended
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        print(f"[phase] {name}: {phase_s[name]:.1f} s ({now - start:.1f} s into the script)", flush=True)

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    set_precision()  # no TF32: the plain versions' f32 convolutions are f32

    fwd_build = conv_build = bwd_build = swin_build = filter_build = None
    for name, (seconds, cached, log) in cuda_build.build_libraries().items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
        print(f"[build] {', '.join(cuda_build.LIBRARIES[name])} for sm_90a: {seconds:.1f}s"
              + (" (cached build)" if cached else f" (nvcc runs together; registers {regs}, spill stores {spills} B)"),
              flush=True)
        if name == "flash_attn_fwd":
            fwd_build = hopper_build_report(log)
        if name == "gn_conv":
            conv_build = gn_conv_build_report(log)
        if name == "flash_attn_bwd":
            bwd_build = bwd_build_report(log)
        if name == "swin_attention":
            swin_build = swin_build_report(log)
        if name == "filter2d":
            filter_build = filter_build_report(log)
    lap("1-2 card, build")

    attn_records = kernel_phase()
    lap("3 K1")
    dq_records, dkv_records, lse_records = backward_phase()
    lap("3 K2")
    d64_fwd, d64_dq, d64_dkv, held64 = d64_phase()
    lap("11 head dim 64")
    d32_fwd, d32_dq, d32_dkv, held32 = d32_phase()
    lap("11 head dim 32")
    planes_records = planes_phase()
    conv_records = conv_phase()
    conv_grads = conv_grad_phase()
    lap("3 prepass, K3")
    stats_records, apply_records, up_records = norm_phase()
    swin_records = swin_phase()
    from instarevive_tpu_torch.tools import time_degrade

    filter_records = time_degrade.hold_filter2d(fail=fail)
    lap("3 K5, K4, K6")
    cfg = load_config(os.path.join(REPO, "configs", "instarevive_v1.yaml"))
    small_pipeline_phase(cfg, conv_records)
    lap("4 small pipeline")
    launches, tiled = pipeline_phase(conv_records, swin_records, attn_records)
    lap("5 pipeline")
    work = tempfile.mkdtemp(prefix="chip_smoke_")  # phase 6's images and phase 10's trace, for phase 16
    atexit.register(shutil.rmtree, work, True)
    cli_phase(work)
    lap("6 CLI")
    serve_phase(cfg, swin_records, launches, conv_records)
    lap("7 server")
    train = train_phase(cfg, conv_records)
    timing = train[2]
    lap("8 DMD trainer")
    degrade_launches, degrade_timing = degrade_phase(filter_records)
    lap("9 degradation")
    swinir_train = swinir_train_phase(cfg, swin_records, filter_records, work)
    lap("10 SwinIR trainer")
    cldm = cldm_phase(held64, conv_records)
    lap("12 cldm trainer")
    # the v1 pipeline in bf16 with 13 ControlNet-Half stages, its projections zero as init_params leaves them
    sampling_pipe = init_params(build_pipeline(cfg, dtype=torch.bfloat16, device="cuda", control_depth=CONTROL_DEPTH),
                                seed=0)
    sample_counts, sample_timing = sample_phase(cfg, sampling_pipe, conv_records, attn_records)
    lap("13 sampling")
    validate_counts, validate_timing = validate_phase(cfg, sampling_pipe, conv_records, swin_records, attn_records,
                                                      filter_records)
    del sampling_pipe
    torch.cuda.empty_cache()
    lap("14 validation")
    sample_2k_counts, sample_2k_timing = sample_2k_phase(conv_records, attn_records)
    torch.cuda.empty_cache()
    lap("15 2K sampling")
    evaluation = evaluation_phase(cfg, work, swin_records)
    torch.cuda.empty_cache()
    lap("16 evaluation")
    aux = aux_phase(cfg, conv_records, attn_records, filter_records)
    torch.cuda.empty_cache()
    lap("17 text, data tools, depth, captioner")
    parallel = parallel_phase(conv_records, swin_records, attn_records)
    torch.cuda.empty_cache()
    lap("18 parallel")
    trainval = trainval_phase(held32, attn_records, lse_records, dq_records, dkv_records, conv_records,
                              (stats_records, apply_records, up_records), work)
    torch.cuda.empty_cache()
    lap("19 training validation")
    d512_grad, vae_grad = vae_grad_phase(held64, conv_records, (stats_records, apply_records, up_records), swin_records)
    lap("20 gradient through the VAE")

    fwd = kernel_entry("flash_attn_fwd", "flash_attn_fwd.cu", "instarevive_tpu/ops/attention.py:63",
                       launches, tiled, attn_records, "dit_self", train)
    fwd["with_lse"] = lse_records  # the training forward: the same kernel writing the row log-sum-exp
    fwd["build"] = fwd_build
    swin = kernel_entry("swin_window_attention", "swin_attention.cu", "instarevive_tpu/ops/swin_attention.py:48",
                        launches, tiled, [r for r in swin_records if r["dtype"] == "bf16"], "process_b4_64x64_shifted",
                        train)
    swin.update(form="swin16", build={k[5:]: v for k, v in swin_build.items() if k.startswith("bf16_")})
    up = kernel_entry("upsample2x", "norm_kernels.cu", "instarevive_tpu/ops/norm_kernels.py:143",
                      launches, tiled, up_records, "b4_256_256", train)
    conv = kernel_entry("gn_silu_conv3x3", "gn_conv.cu", "instarevive_tpu/ops/gn_conv.py:112",
                        launches, tiled, conv_records, "b4_512_128_128", train)
    conv["build"] = {k: v for k, v in conv_build.items() if not k.startswith("f32_")}
    swin["launches_evaluation_residual_swinir"] = evaluation["residual_swinir_launches"]["swin_window_attention"]
    for entry in (swin, up):  # forward launches of the SwinIR trainer; their backward is the plain version's
        entry["launches_swinir_train_run"] = swinir_train[0][entry["name"]]
        entry["launches_swinir_train_step"] = swinir_train[1][entry["name"]]
    kernels = [
        fwd,
        d512_entry(attn_records, fwd_build),
        dict(kernel_entry("flash_attn_bwd_dq", "flash_attn_bwd.cu", "instarevive_tpu/ops/attention.py:127",
                          launches, tiled, dq_records, "dit_self", train), build=bwd_pass(bwd_build, "dq")),
        dict(kernel_entry("flash_attn_bwd_dkv", "flash_attn_bwd.cu", "instarevive_tpu/ops/attention.py:166",
                          launches, tiled, dkv_records, "dit_self", train), build=bwd_pass(bwd_build, "dkv")),
        conv,
        kernel_entry("gn_stats_fold", "norm_kernels.cu", "instarevive_tpu/ops/norm_kernels.py:77",
                     launches, tiled, stats_records, "b4_512_128", train),
        kernel_entry("gn_apply", "norm_kernels.cu", "instarevive_tpu/ops/norm_kernels.py:86",
                     launches, tiled, apply_records, "b4_512_128", train),
        up,
        swin,
        swin_f32_entry(swin_records, swin_build, swinir_train[2]["card_vs_cpu"]["f32_launches"]),
        filter_entry(filter_records, swinir_train[0], train[0], degrade_launches, filter_build),
        *d64_entries(d64_fwd, d64_dq, d64_dkv, cldm[3], bwd_build),
        *f32_entries(attn_records, dq_records, dkv_records, (d64_fwd, d64_dq, d64_dkv), planes_records, fwd_build,
                     bwd_build, {"dmd_f32_step": timing["card_vs_cpu"]["f32_launches"],
                                 "cldm_f32_step": cldm[2]["card_vs_cpu"]["f32_launches"]},
                     conv_records, conv_build, conv_grads),
        *d32_entries(d32_fwd, d32_dq, d32_dkv, trainval["toy"], fwd_build, bwd_build),
        *d512_grad_entries(*d512_grad, vae_grad, bwd_build),
    ]
    f32_d512 = next(e for e in kernels if e["name"] == "flash_attn_fwd_f32_d512")
    f32_d512["with_lse"] = d512_grad[0]  # phase 20: the same kernel writing the row log-sum-exp
    f32_d512["launches_phase20_full_steps"] = {
        "without_lse": sum(step["d512"]["fwd"] for step in vae_grad["full"]["steps"]),
        "with_lse": sum(step["d512"]["fwd_with_lse"] for step in vae_grad["full"]["steps"])}
    next(e for e in kernels if e["name"] == "gn_apply")["input_gradient"] = vae_grad["norm_gradient"]
    fwd["launches_depth_call"] = {t: c["flash_attn_fwd"] for t, c in aux["launches"]["depth"].items()}
    # phase 18's runs by mode: one NCCL rank (the main path's shapes) and two gloo ranks (the new shapes), by K1 shape
    fwd["launches_parallel"] = {
        f"{world}_{mode}": {r["name"]: r[f"launches_parallel_{'' if world == 'nccl1' else 'gloo2_'}{mode}"]
                            for r in attn_records if r["dtype"] == "bf16"
                            and r.get(f"launches_parallel_{'' if world == 'nccl1' else 'gloo2_'}{mode}")}
        for world in ("nccl1", "gloo2") for mode in PARALLEL_MODES}
    for entry in kernels:  # phase 17's calls that launch the kernel, by kernel
        calls = {call: c[entry["name"]] for call, c in aux["launches"].items()
                 if call != "depth" and c.get(entry["name"])}
        if calls:
            entry["launches_phase17"] = calls
    for entry in kernels:  # a 20-step DPM-Solver sample call and a validation batch, by kernel
        if entry["name"] in sample_counts:
            entry["launches_sample_call"] = sample_counts[entry["name"]]
            entry["launches_validate_batch"] = validate_counts[entry["name"]]
            entry["launches_sample_2k_call"] = sample_2k_counts[entry["name"]]
    print(json.dumps({"kernels": kernels, "train": timing, "train_swinir": swinir_train[2], "train_cldm": cldm[2],
                      "degrade": degrade_timing, "sample": sample_timing, "validate": validate_timing,
                      "sample_2k": sample_2k_timing, "evaluate": evaluation, "aux": aux, "parallel": parallel,
                      "trainval": trainval, "vae_grad": vae_grad, "phase_s": phase_s}),
          flush=True)
    print(f"[phase] the script to here: {time.perf_counter() - start:.1f} s; by phase "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
