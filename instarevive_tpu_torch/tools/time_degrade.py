"""Time the degradation synthesis on one CUDA card, and say where the time goes.

    python -m instarevive_tpu_torch.tools.time_degrade [--runs 20] [--profile] [--source NAME=PATH]
        [--unchecked NAME=PATH] [--ablations] [--iters 50]

Holds the ``filter2d`` kernel (``csrc/filter2d.cu``) against its plain version
through its wrapper at the shapes of the two degradation programs at batch 2,
crop 512, at ragged ones and at the card tests' hard ones (one launch a call,
the same bits twice), and
times it beside the plain version (reflect pad + one grouped ``F.conv2d``,
which is also the one library call for this function) and its bound.

With ``--source``, ``--unchecked`` or ``--ablations``, the kernel alone: the
committed file ("main") and each ``--source`` (another ``filter2d.cu``: the
form that launched once a channel range, unpacked from an older tree with
``git archive``, or an edited copy) are built side by side, one nvcc each,
all together; with ``--ablations`` the committed file is built twice more
with ``-DFILTER2D_ABLATE_COPIES_ONLY`` (the copies and their wait, no FMA, no
store) and ``-DFILTER2D_ABLATE_NO_COPIES`` (no copy: the FMAs and the store
on whatever shared memory holds); an ``--unchecked`` file is built and timed
the same way, its error shown, not held. Each build's registers and spills
are printed from ptxas. Every other build is held against ``filter2d_plain``
(1e-5 of the largest magnitude, the same bits twice) at every case, then all
are timed by calling their C launchers directly (no wrapper: the figures are
the kernels', not the host's, except at shapes so small that the launch
itself sets them) in turns, A B then B A. A file whose launcher takes a
channel range (the older form) is launched once a range that fits its
shared memory, as its wrapper did; a file with ``filter2d_plan`` once, as
its launcher plans.

Then it runs ``degrade_batch`` (Real-ESRGAN) and
``degrade_batch_codeformer`` on a seeded (2, 512, 512, 3) batch: walls of
``--runs`` warm calls (host clock around work ending in a synchronise), and
the split of a call by CUDA events around the programs' own steps (blur,
resize, noise, JPEG; the rest is kernel sampling, clamps and the final
rounding). Prints one JSON line. With ``--profile`` it also prints device
time by kernel over one call of each program.

``FILTER_CASES`` (the degradation programs' shapes and ragged ones),
``EDGE_CASES`` (the card tests' hard shapes), ``filter_inputs``,
``hold_filter2d``, ``clean_batch``,
``degradation_setup``, ``forced_gaussian``, ``draws_on`` and ``split_ms`` are
what ``chip_smoke.py`` drives too, so every timing and every card-against-CPU
comparison of the degradation is of one set-up.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List

BATCH, CROP = 2, 512
# The card's published peaks (H100 SXM): device memory bytes/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# The kernel against filter2d_plain, relative to the output's largest
# magnitude: both sum kh * kw products in f32, in another order.
FILTER_REL_BOUND = 1e-5

# (name, image shape (B, H, W, C), (kh, kw), per-sample kernels)
FILTER_CASES = [
    ("realesrgan_hq_b2_512", (2, 512, 512, 3), (21, 21), True),       # stage-1 blur of degrade_batch
    ("realesrgan_canvas1_b2_768", (2, 768, 768, 3), (21, 21), True),  # stage-2 blur on the stage-1 canvas
    ("realesrgan_canvas2_b2_160", (2, 160, 160, 3), (21, 21), True),  # the final sinc on the stage-2 canvas
    ("codeformer_hq_b2_512", (2, 512, 512, 3), (41, 41), True),       # degrade_batch_codeformer's blur
    ("shared_kernel_b2_512", (2, 512, 512, 3), (21, 21), False),
    ("ragged_b1_72x200_k7", (1, 72, 200, 3), (7, 7), True),
    ("ragged_gray_b3_100x36_k21", (3, 100, 36, 1), (21, 21), True),
    ("rectangular_b2_90x130_k5x13", (2, 90, 130, 3), (5, 13), True),
    ("wide_c64_b1_64x96_k41", (1, 64, 96, 64), (41, 41), True),       # 16 bands of 4 channels in one launch
]
# The card tests' shapes that the tiling makes hard: bands of 4, 2 and 1 channels, ragged H and W, reflect at its
# limit. Held and timed beside FILTER_CASES; no degradation program sends them.
EDGE_CASES = [
    ("wide_c128_b1_48x70_k41", (1, 48, 70, 128), (41, 41), True),
    ("gray_b2_37x53_k21", (2, 37, 53, 1), (21, 21), True),
    ("two_channels_b2_45x29_k13", (2, 45, 29, 2), (13, 13), True),
    ("five_channels_b2_19x27_k7", (2, 19, 27, 5), (7, 7), True),
    ("six_channels_b1_130x90_k21_shared", (1, 130, 90, 6), (21, 21), False),
    ("reflect_limit_b1_21x21x2_k41_shared", (1, 21, 21, 2), (41, 41), False),
    ("reflect_limit_b1_41x50_k41_shared", (1, 41, 50, 3), (41, 41), False),
]


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


def filter_inputs(gen, shape, taps, per_sample: bool):
    """A seeded image in [0, 1] and taps with negative lobes (as a sinc has),
    normalised to sum |k| = 1 so that |out| <= 1."""
    import torch

    img = torch.rand(shape, device="cuda", generator=gen)
    kernel = torch.rand(((shape[0],) if per_sample else ()) + tuple(taps), device="cuda", generator=gen) - 0.2
    return img, kernel / kernel.abs().sum(dim=(-2, -1), keepdim=True)


def filter_bound_ms(shape, taps):
    """(least ms the card could take, which limit sets it): image read once
    and written once plus the taps, over the memory rate; 2 kh kw operations
    per output over the f32 rate."""
    b, h, w, c = shape
    n = b * h * w * c
    t_bytes = 4.0 * (2 * n + b * taps[0] * taps[1]) / PEAK_BYTES * 1e3
    t_ops = 2.0 * taps[0] * taps[1] * n / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold_filter2d(cases=FILTER_CASES + EDGE_CASES, fail=None) -> List[Dict[str, object]]:
    """Every case: kernel against ``filter2d_plain`` on the same inputs,
    timed beside it; then a border case that tells reflect from edge repeat.
    ``fail(msg)`` is called on a disagreement (default: raise). Returns
    per-case records."""
    import torch

    from instarevive_tpu_torch.ops.filters import filter2d, filter2d_plain, filter2d_plan

    def default_fail(msg):
        raise AssertionError(msg)

    fail = fail or default_fail
    gen = torch.Generator(device="cuda").manual_seed(11)
    records = []
    for name, shape, taps, per_sample in cases:
        img, kernel = filter_inputs(gen, shape, taps, per_sample)
        before = filter2d.launches
        out = filter2d(img, kernel)
        torch.cuda.synchronize()
        launches = filter2d.launches - before
        ref = filter2d_plain(img, kernel)
        top = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        if not torch.isfinite(out).all() or not err <= FILTER_REL_BOUND * top:
            fail(f"filter2d {name}: kernel differs from the plain version by {err} (largest magnitude {top}, "
                 f"bound {FILTER_REL_BOUND:.0e} of it)")
        if launches != 1 or not torch.equal(filter2d(img, kernel), out):
            fail(f"filter2d {name}: {launches} launches for one call (one expected), or a second call gave other bits")
        ms = cuda_ms(lambda: filter2d(img, kernel), iters=50)
        plain_ms = cuda_ms(lambda: filter2d_plain(img, kernel), iters=5, warmup=1)
        b_ms, b_by = filter_bound_ms(shape, taps)
        plan = filter2d_plan(shape, taps)
        records.append(dict(name=name, dtype="f32", shape=list(shape), taps=list(taps), per_sample=per_sample,
                            launches_per_call=launches, repeats_bits=True, max_abs_err=err, max_rel_err=err / top,
                            bound=FILTER_REL_BOUND, ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms, plan=plan,
                            tflops=2.0 * taps[0] * taps[1] * img.numel() / ms / 1e9))
        print(f"[filter2d] {name:30s} B,H,W,C={shape} taps={taps} per_sample={per_sample} launches={launches} "
              f"max_abs_err={err:.3e} ({err / top:.1e} of the largest magnitude, bound {FILTER_REL_BOUND:.0e}; same "
              f"bits twice) ms={ms:.4f} ({records[-1]['tflops']:.1f} TFLOP/s f32, {b_ms / ms:.0%} of the bound) "
              f"plain_ms={plain_ms:.4f} (= library_ms: reflect pad + one grouped conv2d) bound_ms={b_ms:.4f} ({b_by}) "
              f"plan {plan}", flush=True)
        del img, kernel, out, ref

    # a ramp along x and along y, taps that read one neighbour: reflect gives out[0] = in[1], edge repeat in[0]
    ramp = torch.arange(40, dtype=torch.float32, device="cuda")
    img = (ramp[None, :, None, None] * 100 + ramp[None, None, :, None]).expand(1, 40, 40, 3).contiguous()
    for (i, j), want in (((1, 0), img[0, 0, 1, 0]), ((0, 1), img[0, 1, 0, 0]), ((1, 2), img[0, 0, 38, 0]),
                         ((2, 1), img[0, 38, 0, 0])):
        kernel = torch.zeros(3, 3, device="cuda")
        kernel[i, j] = 1.0
        out = filter2d(img, kernel)
        corner = out[0, 39 if i == 2 else 0, 39 if j == 2 else 0, 0]
        # values up to 3939 in f32; an edge repeat is off by 1 or by 100
        if corner.item() != want.item() or (out - filter2d_plain(img, kernel)).abs().max().item() > 1e-2:
            fail(f"filter2d border case: tap ({i}, {j}) gave {corner.item()} at the border, reflect gives {want.item()}")
    print("[filter2d] border case: one-neighbour taps on a ramp read the reflected pixel (-1 -> 1, H -> H-2), "
          "not the repeated edge, on all four sides", flush=True)
    return records


def clean_batch(batch: int = BATCH, crop: int = CROP, seed: int = 0):
    """A seeded clean batch in [0, 1] on the card, on 8-bit levels as a
    loader's images are: smooth gradients plus noise."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ramp = torch.linspace(0, 1, crop, device="cuda")
    base = ramp[None, :, None, None] * torch.rand(batch, 1, 1, 3, device="cuda", generator=gen) \
        + ramp[None, None, :, None] * torch.rand(batch, 1, 1, 3, device="cuda", generator=gen)
    img = (base / 2 + 0.25 * torch.rand(batch, crop, crop, 3, device="cuda", generator=gen)).clamp(0, 1)
    return torch.round(img * 255) / 255


def degradation_setup(kind: str, seed: int = 0, device="cuda"):
    """(call, config, generators) of one program: ``call(hq01, draws=None)``."""
    from instarevive_tpu_torch.data.codeformer import CodeformerDegradationConfig, degrade_batch_codeformer
    from instarevive_tpu_torch.data.realesrgan import RealESRGANDegradationConfig, degrade_batch
    from instarevive_tpu_torch.ops.degradation import make_generators

    gens = make_generators(seed, device)
    if kind == "realesrgan":
        cfg = RealESRGANDegradationConfig()
        return (lambda hq, draws=None: degrade_batch(gens, hq, cfg, draws=draws)), cfg, gens
    cfg = CodeformerDegradationConfig()
    return (lambda hq, draws=None: degrade_batch_codeformer(gens, hq, cfg, draws=draws)), cfg, gens


def forced_gaussian(draws, shapes, gen):
    """The Real-ESRGAN draws with both noise steps Gaussian and their fields
    made on the CPU from ``gen`` (a Poisson draw cannot be handed from one
    device to the other); ``shapes`` are the two canvases'."""
    import torch

    for noise, shape in zip((draws.noise1, draws.noise2), shapes):
        noise.use_g = True
        noise.fields = (torch.randn(shape, generator=gen), torch.randn((*shape[:3], 1), generator=gen))
    return draws


def draws_on(draws, device):
    """A copy of either program's draws with their noise fields on ``device``."""
    import copy

    out = copy.copy(draws)
    for name in ("noise1", "noise2"):
        if hasattr(out, name):
            noise = copy.copy(getattr(out, name))
            noise.fields = tuple(f.to(device) for f in noise.fields)
            setattr(out, name, noise)
    if getattr(out, "fields", None) is not None:
        out.fields = tuple(f.to(device) for f in out.fields)
    return out


STEPS = {"blur": "filter2d", "resize": "_resize_traced", "jpeg": "jpeg_compress_decompress"}


def split_ms(kind: str, call, hq, runs: int) -> Dict[str, float]:
    """Median CUDA-event milliseconds that ``call(hq)`` spends in the
    program's own steps, summed where a step runs more than once, and in the
    whole call; ``rest`` is the call less its steps (kernel sampling, clamps,
    rounding). The step functions are shadowed in the program's module while
    the call runs, so the split follows whatever the program composes."""
    import torch

    from instarevive_tpu_torch.data import codeformer, realesrgan

    module = realesrgan if kind == "realesrgan" else codeformer
    steps = dict(STEPS, noise="_add_random_noise" if kind == "realesrgan" else "generate_gaussian_noise")
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

    originals = {attr: getattr(module, attr) for attr in steps.values()}
    samples = {n: [] for n in (*steps, "rest", "call")}
    for name, attr in steps.items():
        setattr(module, attr, marked(name, originals[attr]))
    try:
        for _ in range(runs):
            spans.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call(hq)
            end.record()
            torch.cuda.synchronize()
            ms = {n: sum(s.elapsed_time(e) for m, s, e in spans if m == n) for n in steps}
            ms["call"] = start.elapsed_time(end)
            ms["rest"] = ms["call"] - sum(ms[n] for n in steps)
            for n, v in ms.items():
                samples[n].append(v)
    finally:
        for attr, fn in originals.items():
            setattr(module, attr, fn)
    return {n: statistics.median(v) for n, v in samples.items()}


def wall(fn, runs: int) -> List[float]:
    import torch

    out = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def profile_call(what: str, fn) -> None:
    """Device time by kernel over one call, and wall against kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [r for r in rows if not r[2].startswith(("Memcpy", "Memset"))]
    total = sum(r[0] for r in kernels)
    print(f"[profile] {what}: wall {wall_ms:.2f} ms under the profiler, {total:.3f} ms of kernel time in "
          f"{sum(r[1] for r in kernels)} launches; memcpy/memset {sum(r[0] for r in rows) - total:.3f} ms in "
          f"{sum(r[1] for r in rows if r not in kernels)}", flush=True)
    for ms, count, key in sorted(kernels, reverse=True)[:12]:
        print(f"[profile]     {ms:8.3f} ms  x{count:<5d} {key[:140]}", flush=True)


ABLATIONS = {"copies_only": "-DFILTER2D_ABLATE_COPIES_ONLY", "no_copies": "-DFILTER2D_ABLATE_NO_COPIES"}


def build_sources(sources: Dict[str, str], defines: Dict[str, tuple]):
    """name -> path of a library built from each source (with its -D flags),
    one nvcc each, all together; prints each build's registers and spills."""
    import re

    from instarevive_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "filter2d_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        so = out_dir / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defines.get(name, ()), "-o", str(so), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        figures = []
        for fn, body in re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S):
            kernel = re.sub(r"^_ZN.*?filter2d_kernel", "filter2d_kernel", fn)[:40]
            regs = re.search(r"Used (\d+) registers", body).group(1)
            spilled = re.search(r"(\d+) bytes spill stores", body).group(1)
            figures.append(f"{kernel}: {regs} registers, {spilled} B spilled")
        print(f"[build] {name}: " + "; ".join(figures), flush=True)
        libs[name] = so
    return libs


def launcher(so, shape, taps, per_sample, img, kernel, out):
    """A callable that launches one build's kernel through its C launcher
    with the arguments made once, so a timed loop is the launcher's own cost:
    once, as its launcher plans (a file with ``filter2d_plan``), or, for a form
    whose launcher takes a channel range (the older form), once a range that
    fits a block's 232,448 bytes of shared memory, as its wrapper did."""
    import ctypes

    import torch

    lib = ctypes.CDLL(str(so))
    fn = lib.filter2d_f32
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (img.data_ptr(), kernel.data_ptr(), out.data_ptr())
    if hasattr(lib, "filter2d_plan"):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        calls = [(*ptrs, *shape, *taps, int(per_sample), stream)]
    else:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.filter2d_smem_bytes.argtypes = [ctypes.c_int] * 3
        c = shape[3]
        base, per = lib.filter2d_smem_bytes(*taps, 0), lib.filter2d_smem_bytes(*taps, 1)
        chunk = c if per == base else min(c, (232448 - base) // (per - base))
        calls = [(*ptrs, *shape, *taps, int(per_sample), c0, min(chunk, c - c0), stream) for c0 in range(0, c, chunk)]

    def go():
        for args in calls:
            if fn(*args):
                sys.exit(f"{so.name}: launch failed at {shape} x {taps}")

    go.launches = len(calls)
    return go


def kernel_alone(libs, unchecked, iters: int) -> None:
    """Every build held (unless unchecked) at every case, then timed in turns
    (A B, then B A), with the plan the committed file's launcher picks."""
    import torch

    from instarevive_tpu_torch.ops.filters import filter2d_plain, filter2d_plan

    gen = torch.Generator(device="cuda").manual_seed(17)
    cases, failed = [], []
    for name, shape, taps, per_sample in FILTER_CASES + EDGE_CASES:
        img, kernel = filter_inputs(gen, shape, taps, per_sample)
        ref = filter2d_plain(img, kernel)
        out = torch.empty_like(img)
        cases.append((name, shape, taps, per_sample, img, kernel, out))
        top = ref.abs().max().item()
        for lib_name, so in libs.items():
            go = launcher(so, shape, taps, per_sample, img, kernel, out)
            out.fill_(float("nan"))
            go()
            torch.cuda.synchronize()
            first = out.clone()
            go()
            torch.cuda.synchronize()
            err = (first - ref).abs().max().item()
            ok = bool(torch.isfinite(first).all()) and err <= FILTER_REL_BOUND * top and torch.equal(first, out)
            verdict = "not held" if lib_name in unchecked else "ok" if ok else "OVER THE BOUND OR NOT REPEATING"
            print(f"[check] {lib_name:12s} {name:36s} launches={go.launches} max_abs_err={err:.3e} "
                  f"({err / top:.1e} of the largest magnitude; {verdict}) repeats_bits={torch.equal(first, out)}",
                  flush=True)
            if lib_name not in unchecked and not ok:
                failed.append((lib_name, name))
        del ref
    if failed:
        sys.exit(f"over the bound or not repeating its bits: {failed}")
    names = list(libs)
    for r in range(2):
        for name, shape, taps, per_sample, img, kernel, out in cases:
            b_ms, b_by = filter_bound_ms(shape, taps)
            row = []
            for lib_name in names if r == 0 else names[::-1]:
                t = cuda_ms(launcher(libs[lib_name], shape, taps, per_sample, img, kernel, out), iters, 5)
                row.append(f"{lib_name}={t:.4f} ({b_ms / t:.0%})")
            print(f"[time r{r}] {name:36s} ms (share of the bound): " + " ".join(row)
                  + f" bound={b_ms:.4f} ({b_by}); main's plan {filter2d_plan(shape, taps)}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another filter2d.cu")
    ap.add_argument("--unchecked", action="append", default=[], help="NAME=PATH of an ablation, timed only")
    ap.add_argument("--ablations", action="store_true", help="also the committed file as copies only and FMAs only")
    ap.add_argument("--iters", type=int, default=50, help="launches a timing of the kernel alone")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_degrade needs a CUDA device")
    from instarevive_tpu_torch.ops import cuda_build
    from instarevive_tpu_torch.ops.filters import filter2d
    from instarevive_tpu_torch.pipelines.build import set_precision

    set_precision()  # the plain version's f32 convolution is f32, not TF32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "batch": BATCH, "crop": CROP, "filter2d": hold_filter2d()}
    main_src = str(cuda_build.CSRC_DIR / "filter2d.cu")
    sources = {"main": main_src, **dict(s.split("=", 1) for s in args.source + args.unchecked)}
    unchecked = {s.split("=", 1)[0] for s in args.unchecked}
    defines = {}
    if args.ablations:
        for name, flag in ABLATIONS.items():
            sources[name], defines[name] = main_src, (flag,)
            unchecked.add(name)
    if len(sources) > 1:
        kernel_alone(build_sources(sources, defines), unchecked, args.iters)
    hq = clean_batch()
    for kind in ("realesrgan", "codeformer"):
        call, _, _ = degradation_setup(kind)
        for _ in range(3):
            call(hq)
        torch.cuda.synchronize()
        before = filter2d.launches
        walls = wall(lambda: call(hq), args.runs)
        result[kind] = {"wall_s": walls, "wall_median_s": statistics.median(walls),
                        "filter2d_launches_per_call": (filter2d.launches - before) / args.runs,
                        "split_median_ms": split_ms(kind, call, hq, args.runs)}
        if args.profile:
            profile_call(f"one {kind} call", lambda: call(hq))
    print(json.dumps(result), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
