"""Hold and time the bf16 head-dim-64/72 flash-attention forward alone on one
CUDA card, beside another file of the same kernel.

    python -m instarevive_tpu_torch.tools.time_flash_fwd [--source NAME=PATH] [--rounds 2] [--iters 50]

Builds ``csrc/flash_attn_fwd.cu`` as committed ("main") and each ``--source``
(another file with the same C interface, such as an older tree's, unpacked
with ``git archive``), one nvcc each, all together. Each build is held
against ``sdpa`` and ``flash_lse_plain`` at every shape (bounds of
``chip_smoke.py``: 1e-2 and 1e-3) and timed by calling its C launcher
directly (no wrapper, so the figures are the kernel's), in turns: round r
runs the builds in order, then reversed. ``F.scaled_dot_product_attention``
is timed beside them as the yardstick. Then the host time of one launcher
call at two small shapes (d = 64 and 72), on the same tensors every call and
on views at a new address every call (so no tensor map made earlier can be
reused), the builds and the two cases in turns. Prints each build's
registers and spills, one line per check and per timing, and the card line.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# (name, (B, H, Nq, Nk, D), keys kept per sample or None): the DiT's self- and
# cross-attention, the 576 tile's, the UNet's ds-1 and ds-2 self-attention,
# and ragged shapes
SHAPES = [
    ("dit_self", (4, 16, 1024, 1024, 72), None),
    ("dit_cross", (4, 16, 1024, 300, 72), None),
    ("dit_cross_masked", (4, 16, 1024, 300, 72), (300, 180, 0, 61)),
    ("dit_self_tile576", (4, 16, 1296, 1296, 72), None),
    ("ragged_q1000_k333", (1, 16, 1000, 333, 72), None),
    ("unet_ds1_self", (2, 5, 4096, 4096, 64), None),
    ("unet_ds2_self", (2, 10, 1024, 1024, 64), None),
    ("unet_mid_cross4", (2, 20, 64, 4, 64), None),
]
HOST_SHAPES = [("unet_mid_cross4", (2, 20, 64, 4, 64)), ("d72_q64_k77", (2, 16, 64, 77, 72))]
BOUND, LSE_BOUND = 1e-2, 1e-3


def build(sources):
    """name -> path of a built library; the committed source is "main"."""
    from instarevive_tpu_torch.ops import cuda_build

    texts = {"main": (cuda_build.CSRC_DIR / "flash_attn_fwd.cu").read_text()}
    for name, path in sources.items():
        texts[name] = Path(path).read_text()
    out_dir = cuda_build.BUILD_DIR / "flash_fwd_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)]
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
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another flash_attn_fwd.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_flash_fwd needs a CUDA device")
    from instarevive_tpu_torch.ops import attention as A

    sources = dict(s.split("=", 1) for s in args.source)
    libs = build(sources)
    launchers = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).flash_attn_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for label, (b, h, nq, nk, d), kept in SHAPES:
        q = torch.randn(b, h, nq, d, device="cuda", generator=gen).bfloat16()
        k = torch.randn(b, h, nk, d, device="cuda", generator=gen).bfloat16()
        v = (torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1).bfloat16()
        mask = None if kept is None else torch.arange(nk, device="cuda")[None] < torch.tensor(kept, device="cuda")[:, None]
        out, lse = torch.empty_like(q), torch.empty(b, h, nq, device="cuda")
        keys = b * nk if mask is None else int(mask.sum().item())
        cases.append((label, (b, h, nq, nk, d), q, k, v, mask, out, lse, 4.0 * h * nq * keys * d))

    def launch(name, case):
        _, (b, h, nq, nk, d), q, k, v, mask, out, lse, _ = case
        err = launchers[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
                              out.data_ptr(), lse.data_ptr(), b * h, h, nq, nk, d, d**-0.5, 1, stream)
        if err:
            sys.exit(f"{name}: launch failed with CUDA error {err}")

    for case in cases:
        label, shape, q, k, v, mask, out, lse, _ = case
        ref, ref_lse = A.sdpa(q, k, v, kv_mask=mask), A.flash_lse_plain(q, k, mask)
        for name in libs:
            launch(name, case)
            torch.cuda.synchronize()
            err, lse_err = (out.float() - ref.float()).abs().max().item(), (lse - ref_lse).abs().max().item()
            ok = err <= BOUND and lse_err <= LSE_BOUND and bool(torch.isfinite(out).all())
            print(f"[check] {name:10s} {label:18s} {shape} max_abs_err={err:.3e} lse_err={lse_err:.3e} "
                  f"{'ok' if ok else 'OVER THE BOUND'}", flush=True)
            if not ok:
                sys.exit(1)

    def ms(fn):
        for _ in range(5):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    names = list(libs)
    for r in range(args.rounds):
        for case in cases:
            label, shape, q, k, v, mask, out, lse, flops = case
            row = []
            for name in (names if r % 2 == 0 else names[::-1]):
                t = ms(lambda: launch(name, case))
                row.append(f"{name}={t:.4f} ms ({flops / t / 1e9:.0f} TFLOP/s)")
            attn_mask = None if mask is None else mask[:, None, None, :]
            lib = ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
            print(f"[time r{r}] {label:18s} {shape} " + " ".join(row) + f" torch_sdpa={lib:.4f} ms", flush=True)
    # host time of one launcher call, in turns: on the same tensors every call,
    # and on views at a new address every call (the launcher keeps 256 maps)
    calls, reps, addresses = 200, 10, 4096
    for label, (b, h, nq, nk, d) in HOST_SHAPES:
        bufs = [torch.randn(b * h * n * d + 8 * addresses, device="cuda", generator=gen).bfloat16()
                for n in (nq, nk, nk)]
        bases = [buf.data_ptr() for buf in bufs]
        out = torch.empty(b * h * nq * d, device="cuda", dtype=torch.bfloat16)
        lse = torch.empty(b * h * nq, device="cuda")
        out_ptr, lse_ptr = out.data_ptr(), lse.data_ptr()
        walls = {(name, moving): [] for name in names for moving in (False, True)}
        n = 0
        for rep in range(reps):
            for name in (names if rep % 2 == 0 else names[::-1]):
                for moving in ((False, True) if rep % 2 == 0 else (True, False)):
                    fn = launchers[name]
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(calls):
                        off = 16 * (n % addresses) if moving else 0  # 8 bf16 = 16 bytes a step
                        n += 1
                        fn(bases[0] + off, bases[1] + off, bases[2] + off, None, out_ptr, lse_ptr,
                           b * h, h, nq, nk, d, d**-0.5, 1, stream)
                    walls[name, moving].append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
        for name in names:
            same, moved = (statistics.median(walls[name, m]) for m in (False, True))
            print(f"[host] {name:10s} {label:18s} {(b, h, nq, nk, d)} median of {reps}: same tensors {same:.2f} us, "
                  f"a new address each call {moved:.2f} us", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
