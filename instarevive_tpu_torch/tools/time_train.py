"""Time a full-width training step on one CUDA card, and say where the time
goes.

    python -m instarevive_tpu_torch.tools.time_train [--task dmd|swinir|cldm|reflow] [--steps 5] [--depth N]
        [--lowmem] [--profile] [--f32] [--prepass]

Writes seeded PNGs to a temporary folder, builds the trainer's task
(``train.launcher.DMDTask``, ``SwinIRTask`` or ``CLDMTask``) with the
launcher's own flags (bf16 compute from f32 masters, or with ``--f32`` f32
throughout as the trainers default to; batch 2 at 512x512) at
``configs/instarevive_v1.yaml`` (PixArt-XL-2 with every block checkpointed, or
the SwinIR cleaner) or, for cldm and reflow, ``configs/cldm.yaml`` (the SD-2.1
UNet and its ControlNet), takes two warm-up steps and prints one JSON line
with the walls of the next ``--steps`` steps (host clock around work ending in
a synchronise), the split of a step by CUDA events (the degradation, then for
DMD encode, generator update, generator optimizer, fake update, fake
optimizer; for SwinIR forward, backward, optimizer; for cldm and reflow
get_input, forward, backward, optimizer), peak memory and the
attention-kernel launches of one step beside what the configuration implies. With ``--profile`` it also prints
device time by kernel group from ``torch.profiler`` over one step, and that
step's wall against its kernel time. With ``--prepass`` (and ``--f32``) it
tallies one step's launches of the split prepass by shape and times each
shape alone through its C launcher beside its bytes bound.

``train_argv``, ``write_images``, ``expected_launches``,
``cldm_expected_launches`` and ``time_steps`` are what ``chip_smoke.py``'s
train phases drive too, so every timing of the trainer is of one set-up.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

PHASES = ("degrade", "encode", "generator_update", "generator_optimizer", "fake_update", "fake_optimizer")
SWINIR_PHASES = ("degrade", "forward", "backward", "optimizer")
CLDM_PHASES = ("degrade", "get_input", "forward", "backward", "optimizer")
BATCH, CROP = 2, 512


def write_images(folder: str, n: int = 8, size: int = 640, seed: int = 0) -> str:
    """``n`` seeded ``size`` x ``size`` PNGs: smooth gradients plus noise."""
    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 1.0, size, dtype=np.float32)
    for i in range(n):
        base = ramp[None, :, None] * rng.random(3) + ramp[:, None, None] * rng.random(3)
        img = np.clip(base / 2 + 0.25 * rng.random((size, size, 3)), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(folder, f"{i:02d}.png"))
    return folder


def train_argv(config: str, data: str, out: str, steps: int, extra: Optional[List[str]] = None,
               task: str = "dmd", bf16: bool = True) -> List[str]:
    """The launcher's argument list of the full-width run every timing uses
    (bf16 compute from f32 masters; with bf16 False, f32 throughout)."""
    return ["--config", config, "--task", task, "--data", data, "--out", out, *(["--bf16"] if bf16 else []),
            "--batch_size", str(BATCH), "--crop_size", str(CROP), "--steps", str(steps), "--warmup", "1",
            "--log_every", "1", *(extra or [])]


def expected_launches(depth: int, grad_checkpoint: bool = True, encodes: int = 1) -> Dict[str, int]:
    """Attention-kernel launches one DMD step implies. A DiT forward launches
    the forward kernel twice a block (self and cross attention). Forwards:
    the generator with grad, the teacher's CFG pair as one 2B batch, the fake
    score without grad, the fake score with grad; each forward with grad runs
    once more in the backward under checkpointing. Backwards: the generator's
    and the fake score's, each launching the dq and the dk/dv kernel once per
    attention. The VAE encode's mid block launches the forward kernel once."""
    per_forward = 2 * depth
    forwards = 4 + (2 if grad_checkpoint else 0)
    return {"flash_attn_fwd": forwards * per_forward + encodes,
            "flash_attn_bwd_dq": 2 * per_forward, "flash_attn_bwd_dkv": 2 * per_forward}


def cldm_attention_counts(cfg) -> Dict[str, int]:
    """What one ``--task cldm|reflow`` step of ``cfg`` implies for the
    attention kernels (no checkpointing): every SpatialTransformer block of
    the UNet and the ControlNet runs the forward kernel twice (self and
    cross attention) at head dim ``num_head_channels``; those whose inputs
    take a gradient (the ControlNet's and the UNet decoder's: its encoder and
    middle see only z_t and frozen weights) write the log-sum-exp and run the
    dq and the dk/dv kernel once each. The two frozen VAE encodes launch the
    forward kernel once each at head dim 512, in their mid blocks."""
    import torch

    from instarevive_tpu_torch.models.unet import SpatialTransformer, UNetBackbone

    with torch.device("meta"):
        unet, controlnet = UNetBackbone(**cfg["unet"]), UNetBackbone(**cfg["controlnet"])

    def attentions(module):
        return sum(2 * len(m.transformer_blocks) for m in module.modules() if isinstance(m, SpatialTransformer))

    grad = attentions(controlnet) + attentions(unet.output_blocks)
    total = attentions(unet) + attentions(controlnet)
    return {"d64": total, "d64_with_lse": grad, "d512": 2, "flash_attn_fwd": total + 2,
            "flash_attn_bwd_dq": grad, "flash_attn_bwd_dkv": grad}


def cldm_expected_launches(cfg) -> Dict[str, int]:
    """Every kernel's launches in one cldm/reflow step but the degradation's
    filter (its draws decide): the attention as ``cldm_attention_counts``;
    the frozen SwinIR on ``lq`` (one window attention a block, one upsample a
    step of its upsampler); two frozen VAE encodes (as ``expected_launches``
    reckons one)."""
    counts = cldm_attention_counts(cfg)
    levels, blocks = len(cfg["vae"]["ch_mult"]), cfg["vae"]["num_res_blocks"]
    halves = 2 * (levels * blocks + 2)  # fused GN+SiLU+conv launches of one encode
    return {"flash_attn_fwd": counts["flash_attn_fwd"], "flash_attn_bwd_dq": counts["flash_attn_bwd_dq"],
            "flash_attn_bwd_dkv": counts["flash_attn_bwd_dkv"], "gn_silu_conv3x3": 2 * halves,
            "gn_stats_fold": 2 * (halves + 2), "gn_apply": 2 * 2, "upsample2x": 3,
            "swin_window_attention": sum(cfg["swinir"]["depths"]), "filter2d": 0}


def attention_counts() -> Dict[str, int]:
    from instarevive_tpu_torch.ops import attention as A

    return {"flash_attn_fwd": A.flash_attention.launches, "flash_attn_bwd_dq": A.flash_dq.launches,
            "flash_attn_bwd_dkv": A.flash_dkv.launches}


def reset_attention_counts() -> None:
    from instarevive_tpu_torch.ops import attention as A

    A.flash_attention.launches = A.flash_dq.launches = A.flash_dkv.launches = 0


def load_batches(data: str, n: int, seed: int = 0):
    """``n`` loader batches of the trainer's own dataset and loader."""
    from instarevive_tpu_torch.data.dataset import ImageFolderDataset, PrefetchLoader

    loader = PrefetchLoader(ImageFolderDataset(data, out_size=CROP, crop_type="random", seed=seed), BATCH, seed=seed)
    out = []
    while len(out) < n:
        for batch in loader:
            out.append(batch)
            if len(out) == n:
                break
    return out


def time_steps(task, batches, phases=PHASES) -> Dict[str, object]:
    """Run one step per batch on a warm task. Returns the walls (s, each step
    ending in a synchronise), the median CUDA-event ms of each of the task's
    ``phases``, peak allocated GiB over the steps and the attention launches
    of one step."""
    import torch

    marks = []

    def on_phase(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    walls, split = [], {name: [] for name in phases}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    task.on_phase = on_phase
    try:
        for batch in batches:
            marks.clear()
            reset_attention_counts()
            t = time.perf_counter()
            task.run_step(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            for (name, start), (_, end) in zip(marks, marks[1:]):
                split[name].append(start.elapsed_time(end))
    finally:
        task.on_phase = None
    return {"step_s": walls, "step_median_s": statistics.median(walls),
            "phase_median_ms": {name: statistics.median(v) for name, v in split.items()},
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_step": attention_counts()}


GROUPS = {  # first match wins, in this order
    # fp32: the FMA form's namespace at head dim 512 before d512_tf32, for a profile of an older tree
    "K1 flash forward (flash_attn_fwd.cu)": ("hopper::kernel", "d512::kernel", "d512_tf32::kernel", "fwd_tf32::kernel",
                                             "fp32::kernel"),
    # bwd32: the f32 form's namespace before the split-tf32 one, for a profile of an older tree
    "K2a flash dq (flash_attn_bwd.cu)": tuple(f"{ns}::kernel<{d}, {kv}" for ns in ("bwd16", "bwd32", "bwd_tf32")
                                             for d in (64, 72) for kv in ("false", "(bool)0")),
    "K2b flash dk/dv (flash_attn_bwd.cu)": tuple(f"{ns}::kernel<{d}, {kv}" for ns in ("bwd16", "bwd32", "bwd_tf32")
                                               for d in (64, 72) for kv in ("true", "(bool)1")),
    "split prepass of the f32 forms (tf32_planes.cu)": ("tf32_split::kernel",),
    # swin_tc, swin_f32: the forms before swin16 and swin_tf32, for a profile of an older tree
    "K4 window attention (swin_attention.cu)": ("swin16::", "swin_tf32::", "swin_tc::", "swin_f32::"),
    "K5c upsample (norm_kernels.cu)": ("upsample_kernel",),
    "K6 filter2d (filter2d.cu)": ("filter2d_kernel",),
    "optimizer, EMA, clipping (foreach)": ("multi_tensor_apply",),
    # gnconv_f32: the f32 form's namespace before the split-tf32 one, for a profile of an older tree
    "K3 fused GN+SiLU+conv (gn_conv.cu)": ("gnconv_wg::kernel", "gnconv_tf32::kernel", "gnconv_f32::kernel"),
    "K5 GroupNorm (norm_kernels.cu)": ("stats_kernel", "fold_kernel", "apply_kernel"),
    "convolutions (cuDNN)": ("fprop", "dgrad", "wgrad", "cudnn", "conv2d", "implicit_convolve"),
    "GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "cublas"),
    "GroupNorm (torch)": ("group_norm", "GroupNorm", "RowwiseMoments", "ComputeFusedParams"),
    "dtype/layout copies": ("copy_kernel", "CatArrayBatchedCopy", "direct_copy"),
    "LayerNorm": ("layer_norm", "LayerNorm"),
    "other elementwise": ("elementwise_kernel", "vectorized_elementwise"),
    "reductions": ("reduce_kernel",),
}


def profile_step(task, batch) -> None:
    """Device time by kernel group over one step, and wall against kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        task.run_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only: a host function that launches a kernel by ctypes carries that kernel's time too
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [r for r in rows if not r[2].startswith(("Memcpy", "Memset"))]
    total = sum(r[0] for r in kernels)
    print(f"[profile] one step: wall {wall_ms:.1f} ms under the profiler, {total:.1f} ms of kernel time in "
          f"{sum(r[1] for r in kernels)} launches (idle share {max(0.0, 1 - total / wall_ms):.2f}); "
          f"memcpy/memset {sum(r[0] for r in rows) - total:.2f} ms", flush=True)
    left = list(kernels)
    for name, keys in GROUPS.items():
        sel = [r for r in left if any(k in r[2] for k in keys)]
        left = [r for r in left if r not in sel]
        print(f"[profile]   {sum(r[0] for r in sel):9.3f} ms  x{sum(r[1] for r in sel):<6d} {name}", flush=True)
    print(f"[profile]   {sum(r[0] for r in left):9.3f} ms  x{sum(r[1] for r in left):<6d} everything else", flush=True)
    for ms, count, key in sorted(kernels, reverse=True)[:20]:
        print(f"[profile]     {ms:8.3f} ms  x{count:<5d} {key[:140]}", flush=True)


def prepass_alone(task, batch, iters: int = 50) -> Dict[str, float]:
    """The split prepass (``csrc/tf32_planes.cu``) alone: its launches of one
    step tallied by shape, then each shape timed through its C launcher (no
    wrapper) on seeded operands, beside its bytes bound (the operand read
    once, each plane written once, over 3.35 TB/s). Prints a line a shape and
    the launch-weighted sums of one step."""
    import ctypes

    import torch

    from instarevive_tpu_torch.ops import tf32_planes as P
    from instarevive_tpu_torch.ops.cuda_build import load_library

    P.tf32_planes.shapes = {}
    try:
        task.run_step(batch)
        torch.cuda.synchronize()
        shapes = P.tf32_planes.shapes
    finally:
        P.tf32_planes.shapes = None
    fn = load_library("tf32_planes").tf32_planes
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    total = {"launches": 0, "ms": 0.0, "bound_ms": 0.0}
    for (bh, n, d, natural, transposed), count in sorted(shapes.items(), key=lambda kv: -kv[1]):
        x = torch.randn(bh, n, d, device="cuda")
        planes = [torch.empty_like(x) if natural else None for _ in range(2)] + \
            [x.new_empty(bh, d, P.pad8(n)) if transposed else None for _ in range(2)]
        args = (x.data_ptr(), *(None if p is None else p.data_ptr() for p in planes), bh, n, d, stream)
        for _ in range(5):
            fn(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            if fn(*args):
                sys.exit(f"tf32_planes launch failed at {(bh, n, d, natural, transposed)}")
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
        nbytes = 4 * (x.numel() + sum(p.numel() for p in planes if p is not None))
        bound = nbytes / 3.35e12 * 1e3
        total["launches"] += count
        total["ms"] += count * ms
        total["bound_ms"] += count * bound
        print(f"[prepass] (bh, n, d)=({bh}, {n}, {d}) natural={natural} transposed={transposed}: {count} launches a "
              f"step, {ms:.4f} ms alone, bound {bound:.4f} ms (bytes), {bound / ms:.0%} of it", flush=True)
    if total["launches"]:
        print(f"[prepass] one step: {total['launches']} launches, {total['ms']:.2f} ms alone in all against "
              f"{total['bound_ms']:.2f} ms of bytes bound ({total['bound_ms'] / total['ms']:.0%}); launch-weighted gap "
              f"{total['ms'] - total['bound_ms']:.2f} ms a step", flush=True)
    else:
        print("[prepass] no prepass launch in this step (only the f32 forms launch it: add --f32)", flush=True)
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--task", default="dmd", choices=["dmd", "swinir", "cldm", "reflow"])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--degradation", default="realesrgan", choices=["realesrgan", "codeformer"])
    ap.add_argument("--depth", type=int, default=None, help="cut the DiT's depth (default: the config's 28)")
    ap.add_argument("--lowmem", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--f32", action="store_true", help="f32 compute (the trainers' default) instead of bf16")
    ap.add_argument("--prepass", action="store_true", help="the split prepass alone at one step's shapes")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import instarevive_tpu_torch

    # under python -m the package is already the running checkout's, whatever --repo says
    found = os.path.dirname(os.path.dirname(os.path.abspath(instarevive_tpu_torch.__file__)))
    if found != os.path.abspath(args.repo):
        sys.exit(f"time_train: --repo {args.repo} is not the checkout the package came from ({found}); "
                 "run this file by its path to time another tree")
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_train needs a CUDA device")
    from instarevive_tpu_torch.config import load_config, merge
    from instarevive_tpu_torch.train.launcher import TASKS, parse_args

    ldm = args.task in ("cldm", "reflow")
    config = os.path.join(args.repo, "configs", "cldm.yaml" if ldm else "instarevive_v1.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        data = write_images(os.path.join(tmp, "hq"))
        extra = ["--degradation", args.degradation] + (["--lowmem"] if args.lowmem else [])
        targs = parse_args(train_argv(config, data, os.path.join(tmp, "run"), 0, extra, task=args.task, bf16=not args.f32))
        cfg = load_config(config)
        if args.depth is not None:
            cfg = merge(cfg, {"dit": {"depth": args.depth}})
        task = TASKS[args.task](targs, cfg, torch.device("cuda"))
        batches = load_batches(data, 2 + args.steps)
    for batch in batches[:2]:  # builds the kernels, warms the allocator
        task.run_step(batch)
    phases = {"swinir": SWINIR_PHASES, "cldm": CLDM_PHASES, "reflow": CLDM_PHASES}.get(args.task, PHASES)
    result = time_steps(task, batches[2:], phases)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    record = {"card": card, "config": "cldm" if ldm else "instarevive_v1", "task": args.task, "degradation": args.degradation,
              "batch": BATCH, "crop": CROP, "bf16": not args.f32, "lowmem": args.lowmem, **result}
    if args.task == "dmd":
        record.update(depth=task.gen.depth, launches_expected=expected_launches(task.gen.depth, task.gen.grad_checkpoint))
    if ldm:
        record.update(launches_expected=cldm_attention_counts(cfg))
    if args.prepass:
        record["prepass_alone"] = prepass_alone(task, batches[-1])
    print(json.dumps(record), flush=True)
    if args.profile:
        profile_step(task, batches[-1])


if __name__ == "__main__":
    main()
