"""Time the toy training-validation tool on one CUDA card, and find the step
counts at which its asserts hold.

    python -m instarevive_tpu_torch.tools.time_train_validation [--probe] [--every 100] [tool flags]

Tool flags are ``tools/train_validation.py``'s (``--dmd_steps 1200``, ...);
its defaults otherwise. The kernels are built before anything is timed.
Without ``--probe``: the tool's ``main`` whole, and one JSON line with each
stage's wall and steps/s, the kernel launches a step of each training stage
(K1, K2's two passes and the split prepass), peak memory and the figures its
asserts read. With ``--probe``: the tool's stages composed as ``main``
composes them, with the one-step PSNR of the DMD EMA generator against its
init's (on held-out noise drawn before DMD) and the moment distance of the
Reflow EMA generator against its init's read every ``--every`` steps: the
step counts at which ``main``'s two EMA asserts hold. ``--device cpu`` runs
either on the CPU (no launches to count).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from instarevive_tpu_torch.tools import train_validation as tv


def counts() -> dict:
    from instarevive_tpu_torch.ops import attention as A
    from instarevive_tpu_torch.ops.tf32_planes import tf32_planes

    return {"flash_attn_fwd": A.flash_attention.launches, "flash_attn_bwd_dq": A.flash_dq.launches,
            "flash_attn_bwd_dkv": A.flash_dkv.launches, "tf32_planes": tf32_planes.launches}


def card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed(tool_argv) -> dict:
    """The tool's ``main`` at ``tool_argv``, with each stage's launches and wall."""
    device = torch.device(tv.parse_args(tool_argv).device)
    snaps = []

    def on_stage(name):
        sync(device)
        snaps.append((name, counts()))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = tv.main(tool_argv, on_stage=on_stage)
    wall = time.time() - t0
    by_stage = {name: {k: snaps[i + 1][1][k] - c[k] for k in c} for i, (name, c) in enumerate(snaps[:-1])}
    steps, walls = res["steps"], res["walls"]
    train = ("teacher", "dmd", "reflow")
    return {"card": card(), "argv": tool_argv, "wall_s": wall, "walls_s": walls, "steps": steps,
            "s_per_step": {k: walls[k] / steps[k] for k in train},
            "launches_per_step": {k: {n: v / steps[k] for n, v in by_stage[k].items()} for k in train},
            "launches_by_stage": by_stage,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None,
            "psnr": res["psnr"], "ssim": res["ssim"], "reflow_moment_dist": res["reflow_moment_dist"],
            "curve_ends": {k: [v[0], v[-1]] for k, v in res["curves"].items()}}


def probe(tool_argv, every: int) -> dict:
    """The stages of ``main`` with the EMA generators read every ``every`` steps."""
    import copy

    from instarevive_tpu_torch.diffusion.schedules import make_schedule
    from instarevive_tpu_torch.pipelines.build import set_precision
    from instarevive_tpu_torch.train.distill import reflow_sample_1step

    args = tv.parse_args(tool_argv)
    args.log_every = every
    device = tv.device_from(args.device)
    set_precision()
    b, size = args.batch, args.size
    sched = make_schedule("linear", 1000)
    model = tv.build_dit(size, args.patch, args.hidden, args.depth, args.heads, device, seed=0)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    y = torch.zeros((b, 4, 16), device=device)
    generator = torch.Generator(device=device).manual_seed(1)
    t0 = time.time()
    tstate, curve_a = tv.teacher_stage(model.requires_grad_(True).train(), sched, args, y, generator)
    teacher = tv.with_weights(model, tstate.ema_state_dict())
    teacher_eps = tv.model_fn(teacher, y)
    pair_noise, pair_latent = tv.pairs_stage(teacher_eps, sched, args, generator)
    held_noise = torch.randn((b, size, size, 3), generator=generator, device=device)
    held_target = tv.sample_teacher(teacher_eps, sched, held_noise)
    init_q = tv.quality(sched, teacher_eps, held_noise, held_target)
    print(f"[probe +{time.time() - t0:.0f}s] teacher {curve_a[0][1]:.4f} -> {curve_a[-1][1]:.4f}; pairs |x| max "
          f"{pair_latent.abs().max().item():.3f}; DMD init PSNR {init_q[0]:.3f}, SSIM {init_q[1]:.4f}", flush=True)
    dmd_reads = []

    def on_dmd(i, gen_state):
        q = tv.quality(sched, tv.model_fn(tv.with_weights(teacher, gen_state.ema_state_dict()), y), held_noise,
                       held_target)
        dmd_reads.append((i, *q))
        print(f"[probe +{time.time() - t0:.0f}s] DMD step {i}: EMA PSNR {q[0]:.3f} (init {init_q[0]:.3f})", flush=True)

    gen, fake = (copy.deepcopy(teacher).requires_grad_(True).train() for _ in range(2))
    tv.dmd_stage(gen, fake, teacher_eps, sched, args, y, generator, pair_noise, pair_latent, on_chunk=on_dmd)
    del gen, fake
    z_T = torch.randn((b, size, size, 3), generator=generator, device=device)
    data = tv.synth_batch(generator, b, size)

    @torch.no_grad()
    def dist(named):
        return tv.stat_dist(reflow_sample_1step(sched, tv.model_fn(tv.with_weights(model, named), y), z_T, {"y": y}),
                            data)

    d_init = dist(init)
    reflow_reads = []

    def on_reflow(i, state):
        reflow_reads.append((i, dist(state.ema_state_dict())))
        print(f"[probe +{time.time() - t0:.0f}s] Reflow step {i}: EMA moment distance {reflow_reads[-1][1]:.4f} "
              f"(init {d_init:.4f})", flush=True)

    tv.reflow_stage(tv.with_weights(model, init, trainable=True), sched, args, y, generator, on_chunk=on_reflow)
    return {"card": card(), "argv": tool_argv, "every": every, "wall_s": time.time() - t0, "teacher_curve": curve_a,
            "dmd_init": init_q, "dmd_ema": dmd_reads, "reflow_init": d_init, "reflow_ema": reflow_reads,
            "dmd_first_above_init": next((i for i, p, _ in dmd_reads if p > init_q[0]), None),
            "reflow_first_below_init": next((i for i, d in reflow_reads if d < d_init), None)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true", help="read the EMA generators every --every steps")
    ap.add_argument("--every", type=int, default=100)
    args, tool_argv = ap.parse_known_args(argv)
    tool_args = tv.parse_args(tool_argv)
    if tool_args.device == "cuda":
        from instarevive_tpu_torch.ops import cuda_build

        tv.device_from("cuda")
        cuda_build.build_libraries(["flash_attn_fwd", "flash_attn_bwd", "tf32_planes"])
    out = probe(tool_argv, args.every) if args.probe else timed(tool_argv)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
