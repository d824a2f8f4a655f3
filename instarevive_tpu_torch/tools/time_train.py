"""Time the full-width DMD training step on one CUDA card, and say where the
time goes.

    python -m instarevive_tpu_torch.tools.time_train [--steps 5] [--depth N] [--lowmem] [--profile]

Writes seeded PNGs to a temporary folder, builds the trainer's task
(``train.launcher.DMDTask``) with the launcher's own flags at
``configs/instarevive_v1.yaml`` (PixArt-XL-2, bf16 compute from f32 masters,
batch 2 at 512x512, every block checkpointed), takes two warm-up steps and
prints one JSON line with the walls of the next ``--steps`` steps (host clock
around work ending in a synchronise), the split of a step by CUDA events
(encode, generator update, generator optimizer, fake update, fake optimizer),
peak memory and the kernel launches of one step beside what the configuration
implies. With ``--profile`` it also prints device time by kernel group from
``torch.profiler`` over one step, and that step's wall against its kernel time.

``train_argv``, ``write_images``, ``expected_launches`` and ``time_steps`` are
what ``chip_smoke.py``'s train phase drives too, so every timing of the
trainer is of one set-up.
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

PHASES = ("encode", "generator_update", "generator_optimizer", "fake_update", "fake_optimizer")
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


def train_argv(config: str, data: str, out: str, steps: int, extra: Optional[List[str]] = None) -> List[str]:
    """The launcher's argument list of the full-width run every timing uses."""
    return ["--config", config, "--task", "dmd", "--data", data, "--out", out, "--bf16",
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


def time_steps(task, batches) -> Dict[str, object]:
    """Run one step per batch on a warm task. Returns the walls (s, each step
    ending in a synchronise), the median CUDA-event ms of each phase of a step,
    peak allocated GiB over the steps and the attention launches of one step."""
    import torch

    marks = []

    def on_phase(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    walls, split = [], {name: [] for name in PHASES}
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
    "K1 flash forward (flash_attn_fwd.cu)": ("fa2::kernel", "wide::kernel", "fp32::kernel"),
    "K2a flash dq (flash_attn_bwd.cu)": ("bwd16::kernel<false", "bwd16::kernel<(bool)0", "bwd32::kernel<false", "bwd32::kernel<(bool)0"),
    "K2b flash dk/dv (flash_attn_bwd.cu)": ("bwd16::kernel<true", "bwd16::kernel<(bool)1", "bwd32::kernel<true", "bwd32::kernel<(bool)1"),
    "optimizer, EMA, clipping (foreach)": ("multi_tensor_apply",),
    "VAE kernels (gn_conv.cu, norm_kernels.cu)": ("gnconv_tc::kernel", "stats_kernel", "fold_kernel", "apply_kernel"),
    "GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "cublas"),
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--depth", type=int, default=None, help="cut the DiT's depth (default: the config's 28)")
    ap.add_argument("--lowmem", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_train needs a CUDA device")
    from instarevive_tpu_torch.config import load_config, merge
    from instarevive_tpu_torch.train.launcher import DMDTask, parse_args

    config = os.path.join(args.repo, "configs", "instarevive_v1.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        data = write_images(os.path.join(tmp, "hq"))
        targs = parse_args(train_argv(config, data, os.path.join(tmp, "run"), 0, ["--lowmem"] if args.lowmem else []))
        cfg = load_config(config)
        if args.depth is not None:
            cfg = merge(cfg, {"dit": {"depth": args.depth}})
        task = DMDTask(targs, cfg, torch.device("cuda"))
        batches = load_batches(data, 2 + args.steps)
    for batch in batches[:2]:  # builds the kernels, warms the allocator
        task.run_step(batch)
    result = time_steps(task, batches[2:])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    depth = task.gen.depth
    print(json.dumps({"card": card, "config": "instarevive_v1", "depth": depth, "batch": BATCH, "crop": CROP,
                      "bf16": True, "lowmem": args.lowmem, **result,
                      "launches_expected": expected_launches(depth, task.gen.grad_checkpoint)}), flush=True)
    if args.profile:
        profile_step(task, batches[-1])


if __name__ == "__main__":
    main()
