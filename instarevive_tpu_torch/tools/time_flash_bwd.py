"""Hold and time the flash-attention backward (the dq and dk/dv kernels)
alone on one CUDA card, bf16 or f32, beside other files of the same kernels.

    python -m instarevive_tpu_torch.tools.time_flash_bwd [--source NAME=PATH] [--unchecked NAME=PATH]
        [--dims 72,64] [--dtype bf16|f32] [--rounds 2] [--iters 50]

Builds ``csrc/flash_attn_bwd.cu`` as committed ("main") and each ``--source``
(another file with the same C interface, such as an older tree's, unpacked
with ``git archive``, or an edited copy), one nvcc each, all together, and
prints each kernel's registers and spills. Each build is held against
``flash_backward_plain`` at the bf16 shapes of ``chip_smoke.py``'s backward
and head-dim-64 phases (``BACKWARD_CASES``, ``D64_CASES``): dq, dk and dv each
within 1e-2 of the reference's largest magnitude, and the same bits twice.
Then every build is timed by calling its C launchers directly (no wrapper, so
the figures are the kernels'), in turns: round r runs the builds in order,
then reversed. An ``--unchecked`` source is timed but not held: an ablation
that leaves out part of the work, to see what bounds the kernels. The
backward of ``F.scaled_dot_product_attention`` (dq, dk and dv together,
through autograd) is timed beside them as the yardstick, and each shape's
bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, whichever is
larger) is printed. Ends with the card line.

With ``--dtype f32`` the inputs are f32 and the bound 2e-5 (chip_smoke.py's
f32 bound). A build with the split-tf32 entry ``flash_attn_bwd_f32`` is timed
on planes the prepass (``ops/attention.backward_planes``) made once
beforehand, so its figures are the kernels'; the prepass is timed on its own
beside them (``prepass``), and so is the plain version. A build without that
entry (an older tree's) takes f32 through ``flash_attn_bwd_dq`` and
``flash_attn_bwd_dkv``. The bound counts 4-byte elements and three products
for each one at 495 TFLOP/s (TF32).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

# (name, (B, H, Nq, Nk, D), keys kept per sample or None): a DMD train step's
# DiT self- and cross-attention at batch 2, a masked cross-attention and a
# ragged shape (chip_smoke.py's backward phase)
BACKWARD_CASES = [
    ("dit_self", (2, 16, 1024, 1024, 72), None),
    ("dit_cross", (2, 16, 1024, 300, 72), None),
    ("dit_cross_masked", (2, 16, 1024, 300, 72), (77, 300)),
    ("ragged", (1, 16, 1000, 77, 72), None),
]
# The UNet's and the ControlNet's attention at head dim 64 (configs/cldm.yaml at
# batch 2 on 512x512 crops: 64x64 latents, heads = channels / 64): self-attention
# at ds 1, 2, 4 and in the middle block, and cross-attention over the trainer's
# 4-key zero context and over a 77-key CLIP context, one with a ragged mask
# (chip_smoke.py's head-dim-64 phase): (name, (B, H, Nq, Nk), keys kept per sample or None)
D64_CASES = [
    ("ds1_self", (2, 5, 4096, 4096), None),
    ("ds1_cross4", (2, 5, 4096, 4), None),
    ("ds1_cross77", (2, 5, 4096, 77), None),
    ("ds1_cross77_masked", (2, 5, 4096, 77), (77, 20)),
    ("ds2_self", (2, 10, 1024, 1024), None),
    ("ds2_cross4", (2, 10, 1024, 4), None),
    ("ds2_cross77", (2, 10, 1024, 77), None),
    ("ds4_self", (2, 20, 256, 256), None),
    ("ds4_cross4", (2, 20, 256, 4), None),
    ("ds4_cross77", (2, 20, 256, 77), None),
    ("mid_self", (2, 20, 64, 64), None),
    ("mid_cross4", (2, 20, 64, 4), None),
    ("mid_cross77", (2, 20, 64, 77), None),
    ("ragged_q1000_k40_masked", (1, 5, 1000, 40), (33,)),  # ragged Nq, Nk under one key tile
]
# The toy DiT of tools/train_validation.py at its defaults (hidden 128 over 4 heads, 32x32 images in 4x4 patches,
# batch 64, a 4-token zero caption), f32 only (no bf16 form at head dim 32): its self-attention, its cross-attention
# over the 4 caption keys (one dk/dv block a head walks the queries), and a ragged masked shape with a sample whose
# keys are all masked (chip_smoke.py's head-dim-32 phase): (name, (B, H, Nq, Nk), keys kept per sample or None)
D32_CASES = [
    ("toy_self", (64, 4, 64, 64), None),
    ("toy_cross", (64, 4, 64, 4), None),
    ("ragged_masked", (3, 4, 77, 45), (13, 45, 0)),
]
REL_BOUNDS = {"bf16": 1e-2, "f32": 2e-5}  # as chip_smoke.py's BACKWARD_BOUNDS, of each output's largest magnitude
PEAK_BYTES, PEAK_BF16, PEAK_TF32 = 3.35e12, 989e12, 495e12


def cases(dims):
    """(name, (B, H, Nq, Nk, D), kept) of both lists at the head dims asked for."""
    every = BACKWARD_CASES + [(name, (*shape, d), kept) for d, more in ((64, D64_CASES), (32, D32_CASES))
                              for name, shape, kept in more]
    return [case for case in every if case[1][4] in dims]


def bounds_ms(b, h, nq, nk, d, keys, f32=False):
    """The least time of the dq and the dk/dv kernel for these inputs: bf16
    (or f32) operands and outputs, f32 L and di read once, 6 (dq: S, dP, dQ)
    and 8 (dk/dv: S, dP, dV, dK) operations a (query, real key) pair and head
    dim, each three tf32 products in f32."""
    pairs, q_el, k_el, rows = float(h * nq * keys), b * h * nq * d, b * h * nk * d, b * h * nq
    es, rate = (4, PEAK_TF32 / 3) if f32 else (2, PEAK_BF16)
    dq = (es * (3 * q_el + 2 * k_el) + 8 * rows) / PEAK_BYTES, 6.0 * pairs * d / rate
    dkv = (es * (2 * q_el + 4 * k_el) + 8 * rows) / PEAK_BYTES, 8.0 * pairs * d / rate
    return max(dq) * 1e3, max(dkv) * 1e3


def build(sources):
    """name -> path of a built library, and prints its kernels' registers and
    spills; the committed source is "main"."""
    from instarevive_tpu_torch.ops import cuda_build

    paths = {"main": cuda_build.CSRC_DIR / "flash_attn_bwd.cu", **{name: Path(p) for name, p in sources.items()}}
    out_dir = cuda_build.BUILD_DIR / "flash_bwd_sources"
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
        for fn, body in re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry function|\Z)", log, re.S):
            regs = re.search(r"Used (\d+) registers", body)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
            print(f"[build] {name}: {fn} registers {regs and regs.group(1)}, spill stores/loads "
                  f"{spills and spills.groups()}", flush=True)
        warn = [line for line in log.splitlines() if "warning" in line.lower()]
        if warn:
            print(f"[build] {name}: " + " | ".join(warn), flush=True)
        libs[name] = so
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another flash_attn_bwd.cu")
    ap.add_argument("--unchecked", action="append", default=[], help="NAME=PATH of an ablation, timed only")
    ap.add_argument("--dims", default="72,64", help="head dims of the cases to hold and time (32: f32 only)")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_flash_bwd needs a CUDA device")
    from instarevive_tpu_torch.ops import attention as A

    unchecked = dict(s.split("=", 1) for s in args.unchecked)
    libs = build({**dict(s.split("=", 1) for s in args.source), **unchecked})
    f32 = args.dtype == "f32"
    rel_bound, dtype = REL_BOUNDS[args.dtype], torch.float32 if f32 else torch.bfloat16
    launchers, split = {}, {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        if f32 and hasattr(lib, "flash_attn_bwd_f32"):
            fn = lib.flash_attn_bwd_f32
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            split[name] = fn
        for entry, pointers in (("flash_attn_bwd_dq", 8), ("flash_attn_bwd_dkv", 9)):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            launchers[name, entry] = fn
        # the f32 form's blocks of one and of two warpgroups (its launcher takes two where a pass has 128 rows)
        occupancy, forms = ("flash_attn_bwd_occupancy_f32", [(1,), (2,)]) if name in split else \
            ("flash_attn_bwd_occupancy", [()])
        if hasattr(lib, occupancy) and (name in split or not f32):
            occ = getattr(lib, occupancy)
            occ.argtypes = [ctypes.c_int] * (2 + len(forms[0])) + [ctypes.POINTER(ctypes.c_int)] * 2
            occ.restype = ctypes.c_int
            for d in (64, 72):
                for kv in (0, 1):
                    for form in forms:
                        smem, blocks = ctypes.c_int(), ctypes.c_int()
                        if occ(d, kv, *form, ctypes.byref(smem), ctypes.byref(blocks)) == 0:
                            print(f"[build] {name}: d={d} {'dk/dv' if kv else 'dq'}"
                                  f"{f' {form[0]} warpgroup(s)' if form else ''} {smem.value} B of shared memory a "
                                  f"block, {blocks.value} blocks an SM", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(11)
    held = []
    for label, (b, h, nq, nk, d), kept in cases({int(x) for x in args.dims.split(",")}):
        q, k, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype) for n in (nq, nk, nq))
        v = (torch.rand(b, h, nk, d, device="cuda", generator=gen) * 2 - 1).to(dtype)
        mask = None if kept is None else torch.arange(nk, device="cuda")[None] < torch.tensor(kept, device="cuda")[:, None]
        scale = d**-0.5
        with torch.no_grad():
            o, lse = A._forward(q, k, v, mask, scale, want_lse=True)
            di = (do.float() * o.float()).sum(-1)
            ref = A.flash_backward_plain(q, k, v, mask, o, lse, do, scale)
        keys = b * nk if mask is None else int(mask.sum().item())
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        planes = None
        if f32:  # made once: the kernels' figures leave the prepass out
            qn, kn, vn, don = A.backward_planes(q, k, v, do)
            natural = [*qn[:2], *kn[:2], *vn[:2], *don[:2]]
            planes = {"keep": (qn, kn, vn, don)}  # the tensors the pointers below point into
            for kv, transposed in ((False, [*kn[2:]]), (True, [*qn[2:], *don[2:]])):
                planes[kv] = (ctypes.c_void_p * (8 + len(transposed)))(*(p.data_ptr() for p in natural + transposed))
        held.append((label, (b, h, nq, nk, d), q, k, v, do, mask, lse, di, ref, outs,
                     bounds_ms(b, h, nq, nk, d, keys, f32), planes))

    def launch(name, case, which):
        _, (b, h, nq, nk, d), q, k, v, do, mask, lse, di, _, (dq, dk, dv), _, planes = case
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), None if mask is None else mask.data_ptr(),
                lse.data_ptr(), di.data_ptr()]
        outs = [dq.data_ptr()] if which == "dq" else [dk.data_ptr(), dv.data_ptr()]
        if name in split:
            kv = which == "dkv"
            err = split[name](planes[kv], ptrs[4], ptrs[5], ptrs[6], outs[0], outs[1] if kv else None, int(kv),
                              b * h, h, nq, nk, d, d**-0.5, stream)
        else:
            err = launchers[name, f"flash_attn_bwd_{which}"](*ptrs, *outs, b * h, h, nq, nk, d, d**-0.5, int(not f32),
                                                              stream)
        if err:
            sys.exit(f"{name}: flash_attn_bwd_{which} launch failed with CUDA error {err}")

    failed = False
    for case in held:
        label, shape, *_, ref, outs, _, _ = case
        for name in (name for name in libs if name not in unchecked):
            first = []
            for rep in range(2):
                launch(name, case, "dq")
                launch(name, case, "dkv")
                torch.cuda.synchronize()
                first.append([t.clone() for t in outs])
            same = all(torch.equal(x, y) for x, y in zip(*first))
            errs = {key: ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
                    for key, got, want in zip(("dq", "dk", "dv"), outs, ref)}
            ok = same and max(errs.values()) <= rel_bound and all(bool(torch.isfinite(t).all()) for t in outs)
            failed |= not ok
            print(f"[check] {name:10s} {label:24s} {shape} rel_err " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                  + f" same bits twice={same} {'ok' if ok else 'OVER THE BOUND'}", flush=True)
    if failed:
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
        for case in held:
            label, shape, q, k, v, do, mask, lse, di, _, _, (b_dq, b_dkv), planes = case
            row = []
            for name in (names if r % 2 == 0 else names[::-1]):
                t_dq, t_dkv = ms(lambda: launch(name, case, "dq")), ms(lambda: launch(name, case, "dkv"))
                row.append(f"{name}: dq={t_dq:.4f} dkv={t_dkv:.4f}")
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            attn_mask = None if mask is None else mask[:, None, None, :]
            out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask)
            lib = ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
            del out, leaves
            extra = ""
            if f32:
                o = A._forward(q, k, v, mask, shape[4]**-0.5, want_lse=False)[0]
                prepass = ms(lambda: A.backward_planes(q, k, v, do))
                plain = ms(lambda: A.flash_backward_plain(q, k, v, mask, o, lse, do, shape[4]**-0.5))
                extra = f" | prepass={prepass:.4f} plain={plain:.4f}"
            print(f"[time r{r}] {label:24s} {shape} ms " + " | ".join(row) + f" | torch_sdpa_backward={lib:.4f} | "
                  f"bound dq={b_dq:.4f} dkv={b_dkv:.4f}" + extra, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
