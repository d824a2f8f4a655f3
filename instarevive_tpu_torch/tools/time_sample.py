"""Time many-step sampling on one CUDA card, and say where the time goes.

    python -m instarevive_tpu_torch.tools.time_sample [--runs 5] [--profile] \
        [--config configs/pixart_kv2k.yaml --image_size 2048]

Builds ``--config`` (``configs/instarevive_v1.yaml`` by default) in bf16 with
seeded random weights and 13 ControlNet-Half stages (``chip_smoke.py``'s
sampling set-up) and times, host clock around work ending in a synchronise:
a 20-step sample call of each sampler (``sample.sample_images``: two prompts
at ``--image_size`` square, 512 by default, guidance 4.5, so the DiT runs at
batch 4) and a validation batch (``validate.validate_batch``
on a seeded (2, 512, 512, 3) batch: degrade, SwinIR, encode, 20 DPM-Solver
steps over 28 + 13 blocks at batch 2, decode). Prints one JSON line with the
walls and their medians. With ``--profile`` it also times one DiT forward of
each kind alone (wall against kernel time and launches: a wall well above the
kernel time is the host's) and prints device time by kernel over one
DPM-Solver call and one validation batch.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ALGOS = ("dpm-solver", "ddim", "sa-solver", "iddpm")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--config", default="configs/instarevive_v1.yaml", help="relative to the repository root")
    ap.add_argument("--image_size", type=int, default=512, help="the sample calls' side (the validation batch: 512)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_sample needs a CUDA device")
    from instarevive_tpu_torch import sample as S
    from instarevive_tpu_torch import validate as V
    from instarevive_tpu_torch.config import load_config
    from instarevive_tpu_torch.data import realesrgan
    from instarevive_tpu_torch.ops.degradation import make_generators
    from instarevive_tpu_torch.pipelines.build import build_pipeline, init_params
    from instarevive_tpu_torch.tools.time_restore import kernel_table, stage_alone, wall

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cfg = load_config(os.path.join(repo, args.config))
    pipe = init_params(build_pipeline(cfg, dtype=torch.bfloat16, device="cuda", control_depth=13), seed=0)
    y = pipe.dit.y_embedder.y_embedding[: pipe.dit.model_max_length][None].float()
    y2 = y.expand(2, -1, -1)
    shape = S.latent_shape(["a photo", "a red panda"], args.image_size)
    hq = torch.rand(2, 512, 512, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    deg_cfg = realesrgan.RealESRGANDegradationConfig()

    def sample_call(algo):
        gen = torch.Generator(device="cuda").manual_seed(0)
        return lambda: S.sample_images(pipe, y2, y2, shape, algo=algo, step=args.steps, cfg_scale=4.5, generator=gen)

    def validate_call():
        return V.validate_batch(pipe, y, hq, make_generators(231, "cuda"), deg_cfg, args.steps)

    calls = {f"sample {algo}": sample_call(algo) for algo in ALGOS}
    calls["validate batch"] = validate_call
    for fn in calls.values():  # builds the kernels, fills the per-geometry caches
        fn()
    torch.cuda.synchronize()
    walls = {name: wall(fn, args.runs) for name, fn in calls.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "steps": args.steps, "walls_s": walls,
                      "median_s": {n: statistics.median(w) for n, w in walls.items()}}), flush=True)
    if args.profile:
        gen = torch.Generator(device="cuda").manual_seed(1)
        x4 = torch.randn(4, *shape[1:], device="cuda", generator=gen)
        t4 = torch.full((4,), 500.0, device="cuda")
        x2, c2 = (torch.randn(2, 64, 64, 4, device="cuda", generator=gen) for _ in range(2))  # a validation step
        with torch.inference_mode():
            stage_alone(lambda: pipe.dit(x4, t4, y.expand(4, -1, -1)), "DiT forward, batch 4 (a guided step), 28 blocks",
                        args.runs)
            stage_alone(lambda: pipe.dit(x2, t4[:2], y2, c=c2.to(torch.bfloat16), control_depth=13),
                        "DiT forward with ControlNet-Half, batch 2 (a validation step), 28 + 13 blocks", args.runs)
        kernel_table(calls["sample dpm-solver"],
                     f"sample dpm-solver, {args.steps} steps, 2 prompts at {args.image_size}x{args.image_size}")
        kernel_table(validate_call, f"validate batch, 2 x 512x512, {args.steps} steps, 13 stages")


if __name__ == "__main__":
    main()
