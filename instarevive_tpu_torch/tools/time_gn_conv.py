"""Hold and time the fused GroupNorm+SiLU+conv3x3 kernel alone on one CUDA
card, bf16 or f32, beside other files of the same kernel.

    python -m instarevive_tpu_torch.tools.time_gn_conv [--source NAME=PATH] [--unchecked NAME=PATH]
        [--dtype bf16|f32] [--rounds 2] [--iters 20]

Builds ``csrc/gn_conv.cu`` as committed ("main") and each ``--source``
(another file with the same C interface: an older tree's, unpacked with
``git archive``, or an edited copy), one nvcc each, all together; a source
finds the headers it includes beside itself first, then in ``csrc``. Each
build is held against ``gn_silu_conv3x3_plain`` at every shape (bounds of
``chip_smoke.py``: 4e-2 in bf16, 2e-4 in f32) and timed by calling its C
launcher directly on a GroupNorm fold made before (the convolution alone, as
``chip_smoke.py``'s ``conv_only_ms``), in turns: round r runs the builds in
order, then reversed. An ``--unchecked`` source is timed and its error shown
but not held: an ablation that leaves out part of the work, or another design
whose error is the question. cuDNN's ``F.conv2d`` on the activated input
(channels-last, x's dtype; TF32 off) is timed beside them as the yardstick.
Prints each build's registers and spills, one line per check and per
timing, and the card line.

With ``--dtype f32`` the shapes are the f32 paths' (the DMD step's VAE
encode at batch 2 and 512², the restoration shapes the f32 rows held before,
ragged ones). A build whose ``gn_silu_conv3x3_f32`` exists (the split-tf32
form) is timed on the weight's planes made once beforehand
(``ops/gn_conv.weight_planes``), so its figure is the kernel's; the prepass
that makes them is timed on its own beside it (``prepass``). Any other build
(an older tree's) takes the HWIO f32 weight through ``gn_silu_conv3x3``. The
bound of an f32 row is the larger of its bytes over 3.35 TB/s and three times
its operations over 495 TFLOP/s (TF32); the f32 FMA rate's figure (67
TFLOP/s) is printed beside it.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

# (N, H, W, C, Co): the restoration path's shapes (``process`` at 4 x 512², the
# tiled call's encode at 1024² and its 576 tile's decode), and ragged ones
SHAPES = [
    (4, 512, 512, 128, 128), (4, 256, 256, 256, 256), (4, 128, 128, 256, 512), (4, 64, 64, 512, 512),
    (1, 1024, 1024, 128, 128), (1, 72, 72, 512, 512), (1, 144, 144, 512, 512), (1, 288, 288, 256, 256),
    (3, 31, 47, 128, 128), (1, 17, 33, 32, 64), (1, 40, 24, 96, 96),
]
# --dtype f32: the f32 DMD step's VAE encode at batch 2, 512² (each cldm step runs two), the shapes the f32
# rows were held at before, and ragged ones (C = 32 and 96, H and W off the 16-pixel tile)
F32_SHAPES = [
    (2, 512, 512, 128, 128), (2, 256, 256, 128, 256), (2, 256, 256, 256, 256), (2, 128, 128, 256, 512),
    (2, 128, 128, 512, 512), (2, 64, 64, 512, 512),
    (4, 64, 64, 512, 512), (1, 72, 72, 512, 512), (2, 128, 128, 128, 128),
    (3, 31, 47, 128, 128), (2, 9, 21, 128, 256), (1, 17, 33, 32, 64), (1, 40, 24, 96, 96),
]
BOUNDS = {"bf16": 4e-2, "f32": 2e-4}
PEAK_BYTES, PEAK_TF32, PEAK_F32 = 3.35e12, 495e12, 67e12


def build(sources):
    """name -> (path of a built library, its compiler output); the committed source is "main"."""
    from instarevive_tpu_torch.ops import cuda_build

    paths = {"main": cuda_build.CSRC_DIR / "gn_conv.cu", **{name: Path(p) for name, p in sources.items()}}
    out_dir = cuda_build.BUILD_DIR / "gn_conv_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in paths.items():
        so = out_dir / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o", str(so), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        kernels = re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S)
        figures = []
        for fn, body in kernels:
            regs = re.search(r"Used (\d+) registers", body).group(1)
            spilled = re.search(r"(\d+) bytes spill stores", body).group(1)
            figures.append(f"{fn[:60]}: {regs} registers, {spilled} B spilled")
        print(f"[build] {name}: " + "; ".join(figures), flush=True)
        libs[name] = so
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another gn_conv.cu")
    ap.add_argument("--unchecked", action="append", default=[], help="NAME=PATH of an ablation, timed only")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_gn_conv needs a CUDA device")
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3_plain, weight_planes
    from instarevive_tpu_torch.ops.norm_kernels import affine_silu_plain, gn_affine
    from instarevive_tpu_torch.pipelines.build import set_precision

    set_precision()
    f32 = args.dtype == "f32"
    dtype = torch.float32 if f32 else torch.bfloat16
    unchecked = dict(s.split("=", 1) for s in args.unchecked)
    libs = build({**dict(s.split("=", 1) for s in args.source), **unchecked})
    launchers, split = {}, {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fn = lib.gn_silu_conv3x3
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn
        if f32 and hasattr(lib, "gn_silu_conv3x3_f32"):  # the split-tf32 form, on planes
            fn = lib.gn_silu_conv3x3_f32
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            split[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    def ms(fn):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    cases = []
    for n, h, w, c, co in (F32_SHAPES if f32 else SHAPES):
        offset, scale = torch.randn(c, device="cuda", generator=gen), torch.rand(c, device="cuda", generator=gen) + 0.5
        x = (torch.randn(n, h, w, c, device="cuda", generator=gen) * scale + offset).to(dtype)
        gamma = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        wk = (torch.randn(3, 3, c, co, device="cuda", generator=gen) * (9 * c) ** -0.5).to(dtype)
        bias = 0.1 * torch.randn(co, device="cuda", generator=gen)
        a, b = gn_affine(x, gamma, beta)
        out = torch.empty(n, h, w, co, device="cuda", dtype=dtype)
        ref = gn_silu_conv3x3_plain(x, gamma, beta, wk, bias)
        act = affine_silu_plain(x, a, b, silu=True).permute(0, 3, 1, 2)
        w_cl = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        planes = weight_planes(wk) if f32 else None  # made once: the kernel's figure leaves the prepass out
        cases.append(((n, h, w, c, co), x, a, b, wk, bias, out, ref, act, w_cl, 2.0 * n * h * w * 9 * c * co, planes))

    def launch(name, case):
        (n, h, w, c, co), x, a, b, wk, bias, out = case[:7]
        planes = case[11]
        if name in split:
            err = split[name](x.data_ptr(), a.data_ptr(), b.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(),
                              bias.data_ptr(), out.data_ptr(), n, h, w, c, co, stream)
        else:
            err = launchers[name](x.data_ptr(), a.data_ptr(), b.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), n, h, w, c, co, int(not f32), stream)
        if err:
            sys.exit(f"{name}: launch failed with CUDA error {err}")

    bound = BOUNDS[args.dtype]
    failed = []
    for case in cases:
        shape, out, ref = case[0], case[6], case[7]
        for name in libs:
            out.fill_(float("nan"))
            launch(name, case)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            first = out.clone()
            launch(name, case)
            torch.cuda.synchronize()
            ok = err <= bound and bool(torch.isfinite(out).all())
            verdict = "not held" if name in unchecked else "ok" if ok else "OVER THE BOUND"
            print(f"[check] {name:10s} {shape} max_abs_err={err:.3e} (bound {bound:.0e}; {verdict}) "
                  f"repeats_bits={torch.equal(first, out)}", flush=True)
            if not ok and name not in unchecked:
                failed.append((name, shape))
            del first
    if failed:
        sys.exit(f"over the bound: {failed}")
    names = list(libs)
    for r in range(args.rounds):
        for case in cases:
            shape, bias, wk, act, w_cl, flops = case[0], case[5], case[4], case[8], case[9], case[10]
            row = []
            for name in (names if r % 2 == 0 else names[::-1]):
                t = ms(lambda: launch(name, case))
                row.append(f"{name}={t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)")
            lib = ms(lambda: F.conv2d(act, w_cl, bias.to(dtype), padding=1))
            extra = ""
            if f32:
                n, h, w, c, co = shape
                nbytes = 4 * (n * h * w * c + n * h * w * co + 9 * c * co)  # x, out and the weight once
                b_split = max(nbytes / PEAK_BYTES, 3 * flops / PEAK_TF32) * 1e3
                b_fma = max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3
                prepass = ms(lambda: weight_planes(wk))
                extra = f" prepass={prepass:.4f} ms bound={b_split:.4f} ms (split TF32; FMA rate {b_fma:.4f})"
            print(f"[time r{r}] {shape} " + " ".join(row) + f" cudnn_conv={lib:.4f} ms" + extra, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
