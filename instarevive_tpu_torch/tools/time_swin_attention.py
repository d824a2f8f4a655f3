"""Hold and time the window-attention kernel alone on one CUDA card, bf16 or
f32, beside other files of the same kernel.

    python -m instarevive_tpu_torch.tools.time_swin_attention [--dtype bf16|f32] [--source NAME=PATH]
        [--unchecked NAME=PATH] [--ablations] [--rounds 2] [--iters 200]

Builds ``csrc/swin_attention.cu`` as committed ("main") and each ``--source``
(another file with the same C launcher: an older tree's, unpacked with
``git archive``, or an edited copy), one nvcc each, all together; a source
finds the headers it includes beside itself first, then in ``csrc``. With
``--ablations`` the committed file is built four times more, unchecked:
``no_products`` (``-DSWIN_ABLATE_NO_PRODUCTS``: every operand read, no
tensor-core product), ``no_ring`` (``-DSWIN_ABLATE_NO_RING``: the same
shared memory, one slot used, so each item's copy waits for the last one's
products), ``no_bias`` (``-DSWIN_ABLATE_NO_BIAS``: neither the bias nor the
mask read) and ``copies_only`` (``-DSWIN_ABLATE_COPIES_ONLY``: the items'
copies and their waits, no task and no store). Each build's registers and
spills are printed from ptxas, and the main build's shared memory, ring
slots and blocks an SM from its occupancy entry.

Every build is held against ``swin_window_attention_plain`` at every shape
(``chip_smoke.py``'s bounds: 4e-3 in bf16, 1e-5 in f32) and run twice for
the same bits; an ``--unchecked`` build's error is shown, not held. Then
the builds are timed by calling their C launchers directly (no wrapper, so
the figures are the kernels', not the host's), in turns: round r runs them
in order, then reversed, at the v1 width (6 heads of 30) on the shapes the
restoration path, the server and the CLI give the kernel. A file whose
launcher has no occupancy entry (the form before the ring) is given its own
rule's heads a block. Last, the main build at every head-group size its
ring allows ("by heads an item"), and what ``ops.swin_attention
.heads_per_item`` picks. Each line carries the bound: the bytes moved once
(qkv, output, bias, mask) over 3.35 TB/s, or the operations over 989 TFLOP/s
(bf16) or three times them over 495 TFLOP/s (f32 on split tf32), whichever
is larger. The launches reuse one set of buffers, so qkv (24 MB at batch 4)
may be served from L2, as the main path's, made by the launch before, may.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

HEADS, HD, WIN = 6, 30, 8
SHAPES = [  # (B, H, W, shift): process, unshifted, tiled, one 512² image, server buckets, the CLI's 512x832
    (4, 64, 64, 4), (4, 64, 64, 0), (1, 128, 128, 4), (1, 64, 64, 4), (2, 64, 48, 4), (1, 64, 80, 4),
    (1, 64, 104, 4), (4, 64, 64, 3),
]
BOUNDS = {"bf16": 4e-3, "f32": 1e-5}
PEAK_BYTES, PEAK_BF16, PEAK_TF32 = 3.35e12, 989e12, 495e12
ABLATIONS = {"no_products": "-DSWIN_ABLATE_NO_PRODUCTS", "no_ring": "-DSWIN_ABLATE_NO_RING",
             "no_bias": "-DSWIN_ABLATE_NO_BIAS", "copies_only": "-DSWIN_ABLATE_COPIES_ONLY"}


def build(sources, defines):
    """name -> path of a built library; prints each build's registers and spills."""
    from instarevive_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "swin_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources.items():
        so = out_dir / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defines.get(name, ()), "-I", str(Path(path).parent),
               "-I", str(cuda_build.CSRC_DIR), "-o", str(so), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        figures = []
        for fn, body in re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S):
            regs = re.search(r"Used (\d+) registers", body).group(1)
            spilled = re.search(r"(\d+) bytes spill stores", body).group(1)
            figures.append(f"{fn[:40]}: {regs} registers, {spilled} B spilled")
        print(f"[build] {name}: " + "; ".join(figures), flush=True)
        libs[name] = so
    return libs


def old_heads_per_block(windows: int, sms: int) -> int:
    """The rule of the form before the ring: the largest divisor of 6 heads
    that still leaves a block for every SM, else 1."""
    fits = [d for d in (1, 2, 3, 6) if windows * (HEADS // d) >= sms]
    return max(fits, default=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another swin_attention.cu")
    ap.add_argument("--unchecked", action="append", default=[], help="NAME=PATH of an ablation, timed only")
    ap.add_argument("--ablations", action="store_true", help="also the committed file without products, ring, bias, tasks")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_swin_attention needs a CUDA device")
    from instarevive_tpu_torch.ops import cuda_build
    from instarevive_tpu_torch.ops import swin_attention as sa
    from instarevive_tpu_torch.ops import window as W
    from instarevive_tpu_torch.pipelines.build import set_precision

    set_precision()
    bf16 = args.dtype == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    main_src = str(cuda_build.CSRC_DIR / "swin_attention.cu")
    sources = {"main": main_src, **dict(s.split("=", 1) for s in args.source)}
    unchecked = set(dict(s.split("=", 1) for s in args.unchecked))
    sources.update(dict(s.split("=", 1) for s in args.unchecked))
    defines = {}
    if args.ablations:
        for name, flag in ABLATIONS.items():
            sources[name], defines[name] = main_src, (flag,)
            unchecked.add(name)
    libs = build(sources, defines)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launchers, ringed = {}, {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fn = lib.swin_window_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn
        ringed[name] = hasattr(lib, "swin_window_attention_occupancy")
        if name == "main":
            occ = lib.swin_window_attention_occupancy
            occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
            occ.restype = ctypes.c_int
            for g in (1, 2, 3, 6):
                got = [ctypes.c_int() for _ in range(3)]
                if occ(g, HD, int(bf16), *(ctypes.byref(x) for x in got)) == 0:
                    smem, slots, blocks = (x.value for x in got)
                    print(f"[build] main, {args.dtype}, {g} heads an item: {smem} B of shared memory, {slots} slots, "
                          f"{blocks} blocks an SM", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), f"({sms} SMs)", flush=True)

    def ms(fn):
        for _ in range(10):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    cases = []
    c = HEADS * HD
    for b, h, w, shift in SHAPES:
        qkv = torch.randn(b, h, w, 3 * c, device="cuda", generator=gen)
        qkv[..., 2 * c:] = torch.rand(b, h, w, c, device="cuda", generator=gen) * 2 - 1
        qkv = qkv.to(dtype)
        bias = 0.5 * torch.randn(HEADS, WIN**2, WIN**2, device="cuda", generator=gen)
        mask = torch.from_numpy(W.shift_attn_mask(h, w, WIN, shift)).cuda() if shift else None
        out = torch.empty(b, h, w, c, device="cuda", dtype=dtype)
        ref = sa.swin_window_attention_plain(qkv, bias, mask, HEADS, WIN, HD**-0.5, shift)
        windows = b * (h // WIN) * (w // WIN)
        nbytes = qkv.element_size() * (qkv.numel() + out.numel()) + 4 * (bias.numel() + (0 if mask is None else mask.numel()))
        flops = 4.0 * windows * HEADS * WIN**4 * HD
        bound = max(nbytes / PEAK_BYTES, flops / PEAK_BF16 if bf16 else 3 * flops / PEAK_TF32) * 1e3
        cases.append(((b, h, w, shift), qkv, bias, mask, out, ref, windows, bound))

    def launch(name, case, g=None):
        (b, h, w, shift), qkv, bias, mask, out, _, windows, _ = case
        if g is None:
            g = sa.heads_per_item(HEADS, HD, windows, sms, bf16) if ringed[name] else old_heads_per_block(windows, sms)
        fn = launchers[name]
        args = (qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
                b, h, w, HEADS, HD, WIN, shift, HD**-0.5, g, int(bf16), stream)

        def go():  # the arguments made once: the timed loop is the C launcher's own cost
            if fn(*args):
                sys.exit(f"{name}: launch failed")

        return go

    failed = []
    for case in cases:
        shape, out, ref = case[0], case[4], case[5]
        for name in libs:
            out.fill_(float("nan"))
            launch(name, case)()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            first = out.clone()
            launch(name, case)()
            torch.cuda.synchronize()
            ok = err <= BOUNDS[args.dtype] and bool(torch.isfinite(out).all())
            verdict = "not held" if name in unchecked else "ok" if ok else "OVER THE BOUND"
            print(f"[check] {name:12s} {args.dtype} B,H,W,shift={shape} max_abs_err={err:.3e} "
                  f"(bound {BOUNDS[args.dtype]:.0e}; {verdict}) repeats_bits={torch.equal(first, out)}", flush=True)
            if name not in unchecked and not (ok and torch.equal(first, out)):
                failed.append((name, shape))
    if failed:
        sys.exit(f"over the bound or not repeating its bits: {failed}")
    names = list(libs)
    for r in range(args.rounds):
        for case in cases:
            row = [f"{name}={ms(launch(name, case)):.4f}" for name in (names if r % 2 == 0 else names[::-1])]
            print(f"[time r{r}] {args.dtype} B,H,W,shift={case[0]} ({case[6]} windows) ms: " + " ".join(row)
                  + f" bound={case[7]:.4f}", flush=True)
    for case in cases:
        sizes = [g for g in (1, 2, 3, 6) if sa.ring_geometry(g, HD, 2 if bf16 else 4)[0] >= 1]
        times = {g: ms(launch("main", case, g)) for g in sizes}
        print(f"[heads] {args.dtype} B,H,W,shift={case[0]} ({case[6]} windows): main's ms by heads an item "
              + ", ".join(f"{g}: {t:.4f}" for g, t in times.items())
              + f"; the wrapper takes {sa.heads_per_item(HEADS, HD, case[6], sms, bf16)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
