"""Hold and time the bf16 fused GroupNorm+SiLU+conv3x3 kernel alone on one
CUDA card, beside other files of the same kernel.

    python -m instarevive_tpu_torch.tools.time_gn_conv [--source NAME=PATH] [--unchecked NAME=PATH] [--rounds 2] [--iters 20]

Builds ``csrc/gn_conv.cu`` as committed ("main") and each ``--source``
(another file with the same C interface: an older tree's, unpacked with
``git archive``, or an edited copy), one nvcc each, all together; a source
finds the headers it includes beside itself first, then in ``csrc``. Each
build is held against ``gn_silu_conv3x3_plain`` at every shape (bound of
``chip_smoke.py``: 4e-2) and timed by calling its C launcher directly on a
GroupNorm fold made before (the convolution alone, as ``chip_smoke.py``'s
``conv_only_ms``), in turns: round r runs the builds in order, then
reversed. An ``--unchecked`` source is timed but not held: an ablation that
leaves out part of the work, to see what that part costs. cuDNN's
``F.conv2d`` on the activated input (channels-last, bf16) is timed beside
them as the yardstick. Prints each build's registers and
spills, one line per check and per timing, and the card line.
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
BOUND = 4e-2


def build(sources):
    """name -> path of a built library; the committed source is "main"."""
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
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {name}: registers {regs}, spill stores {spills}", flush=True)
        libs[name] = so
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another gn_conv.cu")
    ap.add_argument("--unchecked", action="append", default=[], help="NAME=PATH of an ablation, timed only")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_gn_conv needs a CUDA device")
    from instarevive_tpu_torch.ops.gn_conv import gn_silu_conv3x3_plain
    from instarevive_tpu_torch.ops.norm_kernels import affine_silu_plain, gn_affine
    from instarevive_tpu_torch.pipelines.build import set_precision

    set_precision()
    unchecked = dict(s.split("=", 1) for s in args.unchecked)
    libs = build({**dict(s.split("=", 1) for s in args.source), **unchecked})
    launchers = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).gn_silu_conv3x3
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn
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
    for n, h, w, c, co in SHAPES:
        offset, scale = torch.randn(c, device="cuda", generator=gen), torch.rand(c, device="cuda", generator=gen) + 0.5
        x = (torch.randn(n, h, w, c, device="cuda", generator=gen) * scale + offset).bfloat16()
        gamma = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        beta = 0.1 * torch.randn(c, device="cuda", generator=gen)
        wk = (torch.randn(3, 3, c, co, device="cuda", generator=gen) * (9 * c) ** -0.5).bfloat16()
        bias = 0.1 * torch.randn(co, device="cuda", generator=gen)
        a, b = gn_affine(x, gamma, beta)
        out = torch.empty(n, h, w, co, device="cuda", dtype=torch.bfloat16)
        ref = gn_silu_conv3x3_plain(x, gamma, beta, wk, bias)
        act = affine_silu_plain(x, a, b, silu=True).permute(0, 3, 1, 2)
        w_cl = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cases.append(((n, h, w, c, co), x, a, b, wk, bias, out, ref, act, w_cl, 2.0 * n * h * w * 9 * c * co))

    def launch(name, case):
        (n, h, w, c, co), x, a, b, wk, bias, out = case[:7]
        err = launchers[name](x.data_ptr(), a.data_ptr(), b.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                              out.data_ptr(), n, h, w, c, co, 1, stream)
        if err:
            sys.exit(f"{name}: launch failed with CUDA error {err}")

    for case in cases:
        shape, out, ref = case[0], case[6], case[7]
        for name in (name for name in libs if name not in unchecked):
            out.fill_(float("nan"))
            launch(name, case)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= BOUND and bool(torch.isfinite(out).all())
            print(f"[check] {name:10s} {shape} max_abs_err={err:.3e} {'ok' if ok else 'OVER THE BOUND'}", flush=True)
            if not ok:
                sys.exit(1)
    names = list(libs)
    for r in range(args.rounds):
        for case in cases:
            shape, bias, act, w_cl, flops = case[0], case[5], case[8], case[9], case[10]
            row = []
            for name in (names if r % 2 == 0 else names[::-1]):
                t = ms(lambda: launch(name, case))
                row.append(f"{name}={t:.4f} ms ({flops / t / 1e9:.0f} TFLOP/s)")
            lib = ms(lambda: F.conv2d(act, w_cl, bias.bfloat16(), padding=1))
            print(f"[time r{r}] {shape} " + " ".join(row) + f" cudnn_conv={lib:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
