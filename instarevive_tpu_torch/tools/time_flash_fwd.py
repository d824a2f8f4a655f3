"""Hold and time the flash-attention forward alone on one CUDA card, bf16 or
f32, beside another file of the same kernel.

    python -m instarevive_tpu_torch.tools.time_flash_fwd [--source NAME=PATH] [--unchecked NAME=PATH] [--dims 72,64,512]
        [--dtype bf16|f32] [--rounds 2] [--iters 50]

Builds ``csrc/flash_attn_fwd.cu`` as committed ("main") and each ``--source``
(another file with the same C interface, such as an older tree's, unpacked
with ``git archive``), one nvcc each, all together. Each build is held
against ``sdpa`` and, at head dims 64 and 72, ``flash_lse_plain`` at every
shape of the head dims asked for (bounds of ``chip_smoke.py``: 1e-2 and 2e-2
of the reference's largest magnitude, and 1e-3; head dim 512 writes no
log-sum-exp) and timed by calling its C launcher
directly (no wrapper, so the figures are the kernel's), in turns: round r
runs the builds in order, then reversed. An ``--unchecked`` source is timed
but not held: an ablation that leaves out part of the work, to see what
bounds the kernel. ``F.scaled_dot_product_attention``
is timed beside them as the yardstick. Then (bf16) the host time of one launcher
call at two small shapes (d = 64 and 72), on the same tensors every call and
on views at a new address every call (so no tensor map made earlier can be
reused), the builds and the two cases in turns. Prints each build's
registers and spills, one line per check and per timing, and the card line.

With ``--dtype f32`` the inputs are f32 and the bounds chip_smoke.py's f32
ones (1e-4 absolute and of the reference's largest magnitude, 1e-4 on the
log-sum-exp). A build whose split-tf32 entry ``flash_attn_fwd_f32`` takes
the head dim (its ``flash_attn_fwd_occupancy_f32`` answers for it) is timed
on planes the prepass (``ops/tf32_planes.tf32_planes``) made once beforehand,
so its figure is the kernel's: Q's, K's and V^T's planes at 64 and 72, Q raw
with K's and V^T's planes at 512. The prepass is timed on its own beside it
(``prepass``). Any other build (an older tree's) takes f32 through
``flash_attn_fwd``. The bound of an f32 row is the larger of its bytes over
3.35 TB/s and three times its operations over 495 TFLOP/s (TF32).
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
# the VAE mid block's in process at 4 x 512^2, in the tiled 1024^2 call's
# encode and in its 576 tile's decode, and ragged shapes
SHAPES = [
    ("dit_self", (4, 16, 1024, 1024, 72), None),
    ("dit_cross", (4, 16, 1024, 300, 72), None),
    ("dit_cross_masked", (4, 16, 1024, 300, 72), (300, 180, 0, 61)),
    ("dit_self_tile576", (4, 16, 1296, 1296, 72), None),
    ("ragged_q1000_k333", (1, 16, 1000, 333, 72), None),
    ("unet_ds1_self", (2, 5, 4096, 4096, 64), None),
    ("unet_ds2_self", (2, 10, 1024, 1024, 64), None),
    ("unet_mid_cross4", (2, 20, 64, 4, 64), None),
    ("vae_mid", (4, 1, 4096, 4096, 512), None),
    ("vae_mid_tiled_encode", (1, 1, 16384, 16384, 512), None),
    ("vae_mid_tile576_decode", (1, 1, 5184, 5184, 512), None),
    ("ragged_d512_masked", (2, 1, 1000, 333, 512), (199, 0)),
]
# --dtype f32: the f32 trainers' shapes (the DiT at a DMD step's batch 2, the UNet's), the DMD step's
# frozen-VAE encode at batch 2 and a ragged masked head-dim-512 shape with a sample whose keys are all masked
F32_SHAPES = [
    ("dit_self_b2", (2, 16, 1024, 1024, 72), None),
    ("dit_self", (4, 16, 1024, 1024, 72), None),
    ("dit_cross_masked", (4, 16, 1024, 300, 72), (300, 180, 0, 61)),
    ("ragged_q1000_k77", (1, 16, 1000, 77, 72), None),
    ("unet_ds1_self", (2, 5, 4096, 4096, 64), None),
    ("unet_ds2_self", (2, 10, 1024, 1024, 64), None),
    ("unet_mid_cross4", (2, 20, 64, 4, 64), None),
    ("vae_mid_dmd_encode", (2, 1, 4096, 4096, 512), None),
    ("ragged_d512_masked", (2, 1, 1000, 333, 512), (199, 0)),
    # head dim 32 (f32 only): the toy DiT of tools/train_validation.py, its self-attention and its 4 caption keys
    ("toy_self", (64, 4, 64, 64, 32), None),
    ("toy_cross", (64, 4, 64, 4, 32), None),
]
HOST_SHAPES = [("unet_mid_cross4", (2, 20, 64, 4, 64)), ("d72_q64_k77", (2, 16, 64, 77, 72))]
BOUNDS = {"bf16": (1e-2, 2e-2, 1e-3), "f32": (1e-4, 1e-4, 1e-4)}  # as chip_smoke.py: absolute, of max|ref|, of the lse
PEAK_BYTES, PEAK_TF32 = 3.35e12, 495e12


def f32_bound_ms(nbytes, flops):
    """The least time of an f32 forward: bytes over the memory rate, or the
    split-tf32 products (three a product) over the TF32 rate."""
    return max(nbytes / PEAK_BYTES, 3 * flops / PEAK_TF32) * 1e3


def build(sources):
    """name -> path of a built library; the committed source is "main"."""
    from instarevive_tpu_torch.ops import cuda_build

    paths = {"main": cuda_build.CSRC_DIR / "flash_attn_fwd.cu", **{name: Path(p) for name, p in sources.items()}}
    out_dir = cuda_build.BUILD_DIR / "flash_fwd_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in paths.items():
        so = out_dir / f"lib{name}.so"
        # a source finds the headers it includes beside itself first, then in csrc
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
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another flash_attn_fwd.cu")
    ap.add_argument("--unchecked", action="append", default=[], help="NAME=PATH of an ablation, timed only")
    ap.add_argument("--dims", default="72,64,512", help="head dims of SHAPES to hold and time")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_flash_fwd needs a CUDA device")
    from instarevive_tpu_torch.ops import attention as A

    unchecked = dict(s.split("=", 1) for s in args.unchecked)
    libs = build({**dict(s.split("=", 1) for s in args.source), **unchecked})
    f32 = args.dtype == "f32"
    bound, rel_bound, lse_bound = BOUNDS[args.dtype]
    launchers, split = {}, {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fn = lib.flash_attn_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn
        if f32 and hasattr(lib, "flash_attn_fwd_f32"):  # the split-tf32 forms, at the head dims they take
            fn = lib.flash_attn_fwd_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            occupancy = lib.flash_attn_fwd_occupancy_f32
            occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            split[name] = (fn, {d for d in (32, 64, 72, 512) if occupancy(d, ctypes.byref(smem), ctypes.byref(blocks)) == 0})
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    dims = {int(d) for d in args.dims.split(",")}
    dtype = torch.float32 if f32 else torch.bfloat16
    for label, (b, h, nq, nk, d), kept in (case for case in (F32_SHAPES if f32 else SHAPES) if case[1][4] in dims):
        q = torch.randn(b, h, nq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, h, nk, d, device="cuda", generator=gen).to(dtype)
        v = (torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1).to(dtype)
        mask = None if kept is None else torch.arange(nk, device="cuda")[None] < torch.tensor(kept, device="cuda")[:, None]
        out = torch.empty_like(q)
        lse = torch.empty(b, h, nq, device="cuda") if d in A.GRAD_HEAD_DIMS[dtype] else None  # none at 512
        keys = b * nk if mask is None else int(mask.sum().item())
        planes = None
        if f32:  # made once: the kernels' figures leave the prepass out; at 512 Q goes raw
            planes = [*([q] if d == 512 else A.tf32_planes(q)[:2]), *A.tf32_planes(k)[:2],
                      *A.tf32_planes(v, natural=False, transposed=True)[2:]]
        cases.append((label, (b, h, nq, nk, d), q, k, v, mask, out, lse, 4.0 * h * nq * keys * d, planes))

    def launch(name, case):
        _, (b, h, nq, nk, d), q, k, v, mask, out, lse, _, planes = case
        mask_ptr, lse_ptr = None if mask is None else mask.data_ptr(), None if lse is None else lse.data_ptr()
        if planes is not None and name in split and d in split[name][1]:
            err = split[name][0]((ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes)), mask_ptr,
                                 out.data_ptr(), lse_ptr, b * h, h, nq, nk, d, d**-0.5, stream)
        else:
            err = launchers[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), lse_ptr,
                                  b * h, h, nq, nk, d, d**-0.5, int(not f32), stream)
        if err:
            sys.exit(f"{name}: launch failed with CUDA error {err}")

    for case in cases:
        label, shape, q, k, v, mask, out, lse, *_ = case
        ref = A.sdpa(q, k, v, kv_mask=mask)
        ref_lse = None if lse is None else A.flash_lse_plain(q, k, mask)
        for name in (name for name in libs if name not in unchecked):
            launch(name, case)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = 0.0 if lse is None else (lse - ref_lse).abs().max().item()
            ok = (err <= min(bound, rel_bound * ref.float().abs().max().item()) and lse_err <= lse_bound
                  and bool(torch.isfinite(out).all()))
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
            label, shape, q, k, v, mask, out, lse, flops, planes = case
            row = []
            for name in (names if r % 2 == 0 else names[::-1]):
                t = ms(lambda: launch(name, case))
                row.append(f"{name}={t:.4f} ms ({flops / t / 1e9:.0f} TFLOP/s)")
            attn_mask = None if mask is None else mask[:, None, None, :]
            lib = ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
            extra = ""
            if f32:
                b, h, nq, nk, d = shape
                split_inputs = [(k, True, False), (v, False, True)] + ([] if d == 512 else [(q, True, False)])
                prepass = ms(lambda: [A.tf32_planes(*x) for x in split_inputs])
                plain = ms(lambda: A.sdpa(q, k, v, kv_mask=mask))
                nbytes = 4 * (2 * q.numel() + 2 * k.numel())
                extra += f" prepass={prepass:.4f} ms plain_sdpa={plain:.4f} ms bound={f32_bound_ms(nbytes, flops):.4f} ms"
            print(f"[time r{r}] {label:18s} {shape} " + " ".join(row) + f" torch_sdpa={lib:.4f} ms" + extra, flush=True)
    # host time of one launcher call, in turns: on the same tensors every call,
    # and on views at a new address every call (the launcher keeps 256 maps)
    calls, reps, addresses = 200, 10, 4096
    for label, (b, h, nq, nk, d) in (case for case in HOST_SHAPES if case[1][4] in dims and not f32):
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
