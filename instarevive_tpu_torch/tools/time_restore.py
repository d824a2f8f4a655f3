"""Time the full-width restoration path on one CUDA card, and say where the
time goes.

    python -m instarevive_tpu_torch.tools.time_restore [--repo DIR] [--runs 5] [--profile]

Builds ``configs/instarevive_v1.yaml`` in bf16 with seeded random weights and
runs ``process`` on a 4x512x512 batch and ``process_tiled`` on one 1024x1024
image (auto tile geometry). Prints one JSON line with the warm wall times
(host clock around work ending in a synchronise) and their medians. With
``--profile`` it also prints, for each of the two calls, the stage split
(CUDA events around the pipeline's ``clean``, ``encode``, ``one_step`` and
``decode`` as the call itself runs them), SwinIR by itself (wall against
kernel time and launches) and device time by kernel from ``torch.profiler``. ``build_v1`` and ``wall`` are what ``chip_smoke.py``
drives too, so every timing of the port is of one set-up.
``--repo`` names the checkout to import the package and read the config
from, so that one copy of this script can time two trees in turn (see
``ab_trees.py``). It uses only entry points every version of the port has.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def build_v1(repo: str):
    """The full-width ``configs/instarevive_v1.yaml`` pipeline of the checkout
    ``repo`` (already on ``sys.path``) in bf16 with seeded random weights, and
    the two calls every timing of the port drives: ``process`` on a seeded
    4x512x512 batch and ``process_tiled`` on one 1024x1024 image at the auto
    tile geometry. Returns a namespace with ``pipe``, the two closures, and
    the sizes."""
    import types

    import torch

    from instarevive_tpu_torch.config import load_config
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params
    from instarevive_tpu_torch.pipelines.restore import auto_tile_geometry

    cfg = load_config(os.path.join(repo, "configs", "instarevive_v1.yaml"))
    pipe = init_params(build_pipeline(cfg, dtype=torch.bfloat16, device="cuda"), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch, size, large = 4, 512, 1024
    lq = torch.rand(batch, size, size, 3, device="cuda", generator=gen)
    lq1 = torch.rand(1, large, large, 3, device="cuda", generator=gen)
    y = pipe.dit.y_embedder.y_embedding[:300][None].float().repeat(batch, 1, 1)
    tile, stride = auto_tile_geometry(large, large)
    return types.SimpleNamespace(
        pipe=pipe, batch=batch, size=size, large=large, tile=tile, stride=stride, lq=lq, lq1=lq1,
        process=lambda: pipe.process(lq, y),
        process_tiled=lambda: pipe.process_tiled(lq1, y[:1], tile_size=tile, tile_stride=stride))


def wall(fn, runs: int):
    """Seconds on the host clock of each of ``runs`` calls, each ending in a
    synchronise."""
    import torch

    out = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


STAGES = ("clean", "encode", "one_step", "decode")


def stage_ms(pipe, call, runs: int):
    """Median CUDA-event milliseconds that ``call`` (a closure over ``pipe``'s
    ``process`` or ``process_tiled``) spends in each of the pipeline's own
    stage methods, summed where a stage runs more than once, and in the whole
    call; ``rest`` is the call less its stages (color fix, tile averaging,
    clamp). The stage methods are shadowed on the instance while ``call``
    runs, so the split follows whatever the entry point composes."""
    import torch

    spans = []

    def marked(name, fn):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((name, start, end))
            return out
        return run

    samples = {n: [] for n in STAGES + ("rest", "call")}
    for name in STAGES:
        setattr(pipe, name, marked(name, getattr(pipe, name)))
    try:
        for _ in range(runs):
            spans.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            ms = {n: sum(s.elapsed_time(e) for m, s, e in spans if m == n) for n in STAGES}
            ms["call"] = start.elapsed_time(end)
            ms["rest"] = ms["call"] - sum(ms[n] for n in STAGES)
            for n, v in ms.items():
                samples[n].append(v)
    finally:
        for name in STAGES:
            delattr(pipe, name)
    return {n: statistics.median(v) for n, v in samples.items()}


def device_rows(fn):
    """(rows of (ms, launches, name) for every kernel of one profiled call of
    ``fn``, the profiler's averages, the call's wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.self_device_time_total > 0 and not e.key.startswith(("aten::", "cuda", "Memcpy", "Memset", "Activity"))]
    return rows, prof, wall_ms


def stage_alone(fn, label: str, runs: int) -> None:
    """One stage by itself: its wall (host clock to a synchronise, median of
    ``runs``) against the kernel time and launches of one profiled call. A
    wall well above the kernel time means the host, not the card, sets the
    stage's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = [w * 1e3 for w in wall(fn, runs)]
    rows, _, _ = device_rows(fn)
    print(f"[alone] {label}: wall ms median {statistics.median(walls):.2f} (runs {', '.join(f'{w:.2f}' for w in walls)}); "
          f"{sum(r[0] for r in rows):.2f} ms of kernel time in {sum(r[1] for r in rows)} launches", flush=True)


def kernel_table(fn, label: str, top: int = 28) -> None:
    """Device time by kernel over one call of ``fn``."""
    rows, prof, wall_ms = device_rows(fn)
    copies = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
              if e.self_device_time_total > 0 and e.key.startswith(("Memcpy", "Memset"))]
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"[profile] {label}: {total:.1f} ms of kernel time in a {wall_ms:.1f} ms profiled call; "
          f"copies {sum(c[0] for c in copies):.2f} ms", flush=True)
    for ms, count, key in rows[:top]:
        print(f"[profile]   {ms:8.3f} ms  x{count:<4d} {key[:150]}", flush=True)
    groups = {"fused GN+SiLU+conv (gn_conv.cu)": ("gnconv_wg::kernel", "gnconv_tf32::kernel", "gnconv_f32::kernel"),
              "GroupNorm, upsample (norm_kernels.cu)": ("stats_kernel", "fold_kernel", "apply_kernel", "upsample_kernel"),
              "flash attention at head dims 64/72 (flash_attn_fwd.cu)": ("hopper::kernel", "fwd_tf32::kernel"),
              "flash attention at head dim 512 (flash_attn_fwd.cu)": ("d512::kernel", "d512_tf32::kernel"),
              # swin_tc, swin_f32: the forms before swin16 and swin_tf32, for a profile of an older tree
              "window attention (swin_attention.cu)": ("swin16::kernel", "swin_tf32::kernel", "swin_tc::kernel",
                                                       "swin_f32::kernel"),
              "layout transposes": ("nchwToNhwc", "nhwcToNchw"),
              "library GroupNorm": ("GroupNorm", "group_norm", "RowwiseMoments"),
              "dtype/layout copies": ("copy_kernel", "CatArrayBatchedCopy", "direct_copy"),
              "rolls": ("roll_cuda_kernel",)}
    for name, keys in groups.items():
        sel = [r for r in rows if any(k in r[2] for k in keys)]
        print(f"[profile]   group {name}: {sum(r[0] for r in sel):.3f} ms in {sum(r[1] for r in sel)} launches", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import instarevive_tpu_torch

    # under python -m the package is already the running checkout's, whatever --repo says
    found = os.path.dirname(os.path.dirname(os.path.abspath(instarevive_tpu_torch.__file__)))
    if found != os.path.abspath(args.repo):
        sys.exit(f"time_restore: --repo {args.repo} is not the checkout the package came from ({found}); "
                 "run this file by its path to time another tree")
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_restore needs a CUDA device")
    v1 = build_v1(args.repo)
    for fn in (v1.process, v1.process_tiled):  # builds the kernels, fills the per-geometry caches
        fn()
        fn()
    torch.cuda.synchronize()
    t_process, t_tiled = wall(v1.process, args.runs), wall(v1.process_tiled, args.runs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "repo": os.path.abspath(args.repo), "card": card,
                      "process_4x512_s": t_process, "process_4x512_median_s": statistics.median(t_process),
                      "tiled_1x1024_s": t_tiled, "tiled_1x1024_median_s": statistics.median(t_tiled)}), flush=True)
    if args.profile:
        calls = (("process 4x512x512", v1.process),
                 (f"process_tiled 1x1024x1024 at {v1.tile}/{v1.stride}", v1.process_tiled))
        for label, fn in calls:
            stages = stage_ms(v1.pipe, fn, args.runs)
            print(f"[stages] {label}, median ms of {args.runs}: "
                  + ", ".join(f"{n} {v:.2f}" for n, v in stages.items()), flush=True)
        with torch.inference_mode():
            stage_alone(lambda: v1.pipe.clean(v1.lq), "SwinIR (clean) on 4x512x512", args.runs)
            stage_alone(lambda: v1.pipe.clean(v1.lq1), "SwinIR (clean) on 1x1024x1024", args.runs)
        for label, fn in calls:
            kernel_table(fn, label)

if __name__ == "__main__":
    main()
