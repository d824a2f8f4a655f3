"""PixArt text-to-image sampling CLI, the PyTorch port of ``sample.py``.

    python -m instarevive_tpu_torch.sample --random_init [--device cuda|cpu] \\
        --prompt "a photo" "a red panda --ar 3:4" --sampling_algo dpm-solver \\
        --step 20 --cfg_scale 4.5 [--config configs/instarevive_v1.yaml]

Samplers: iddpm (ancestral DDPM over ``--step`` respaced steps, 100 when
``--step`` is 0), ddim, dpm-solver (DPM-Solver++ 2M at ``--solver_order 2``
multistep, else the solver family), sa-solver (SA-Solver, predictor order
``--solver_order`` + 1, at most 3). Classifier-free guidance runs the
conditional and the null rows in one DiT call and mixes the eps channels;
the variance channels come from the conditional rows. A ``--ar h:w`` suffix
on a prompt picks the aspect bucket of the latent. On the card the DiT and
the VAE compute in bf16 (``--bf16`` asks for it on the CPU too); the solver
state, its coefficients and the guidance mix stay float32.

Prompts are not encoded yet (T5 is not ported): every sample uses the
checkpoint's learned null caption embedding, and ``--t5_dir`` is refused, as
are the mesh flags ``--seq_parallel`` and ``--pipeline_parallel``.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from typing import Optional, Sequence

ALGOS = ("iddpm", "ddim", "dpm-solver", "sa-solver")


def parse_args(argv=None):
    from instarevive_tpu_torch.inference import add_model_args

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--prompt", nargs="+", default=["a photo"])
    p.add_argument("--t5_dir", default=None, help="refused: T5 text encoding is not ported yet")
    p.add_argument("--output", default="samples")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--sampling_algo", default="dpm-solver", choices=ALGOS)
    p.add_argument("--solver_order", type=int, default=2, help="DPM-Solver order (1-3) / SA-Solver predictor order")
    p.add_argument("--solver_method", default="multistep", choices=["multistep", "singlestep", "singlestep_fixed"])
    p.add_argument("--sa_tau", type=float, default=1.0, help="SA-Solver stochasticity (0 = ODE limit)")
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--cfg_scale", type=float, default=4.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq_parallel", type=int, default=0, help="refused: the mesh is not ported yet")
    p.add_argument("--pipeline_parallel", type=int, default=0, help="refused: the mesh is not ported yet")
    args = p.parse_args(argv)
    if args.t5_dir:
        p.error("--t5_dir: T5 text encoding is not ported yet; sampling takes the null caption embedding")
    for flag in ("seq_parallel", "pipeline_parallel"):
        if getattr(args, flag) > 1:
            p.error(f"--{flag}: the device mesh is not ported yet; sampling runs on one device")
    return args


def latent_shape(prompts: Sequence[str], image_size: int, latent_factor: int = 8):
    """(B, h, w, 4): the aspect bucket of the first prompt with a ``--ar``
    suffix, else ``image_size`` square."""
    from instarevive_tpu_torch.data.dataset import closest_bucket, parse_prompt_aspect

    ratios = [parse_prompt_aspect(pr)[1] for pr in prompts]
    if any(r is not None for r in ratios):
        hh, ww = closest_bucket(next(r for r in ratios if r is not None))
    else:
        hh = ww = image_size
    return (len(prompts), hh // latent_factor, ww // latent_factor, 4)


def guided_model(pipe, y, null, cfg_scale: float):
    """model_fn(x, t) -> the DiT's float32 output (eps and variance channels)
    under classifier-free guidance; y, null: (B, L, C) caption embeddings."""
    from instarevive_tpu_torch.diffusion.one_step import cfg_wrap

    def dit(x, t, y):
        return pipe.dit(x, t.float(), y).float()

    guided = cfg_wrap(dit, cfg_scale, {"y": null}, split_channels=pipe.dit.x_embedder.proj.in_channels)
    return lambda x, t: guided(x, t, y=y)


@functools.lru_cache(maxsize=8)
def respaced(spec: str):
    """The linear 1000-step schedule respaced by ``spec``, made once: its
    tables are copied to the device once, on first use."""
    from instarevive_tpu_torch.diffusion.respace import respaced_schedule

    return respaced_schedule("linear", 1000, spec)


def sample_latents(pipe, y, null, shape, *, algo: str = "dpm-solver", step: int = 20, cfg_scale: float = 4.5,
                   solver_order: int = 2, solver_method: str = "multistep", sa_tau: float = 1.0,
                   generator=None, x_init=None):
    """The sampled latents (B, h, w, 4), float32. ``x_init`` is the initial
    noise; else it is drawn from ``generator``, on the generator's device, as
    is every later draw of the stochastic samplers."""
    import torch

    from instarevive_tpu_torch.diffusion import gaussian as G
    from instarevive_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m, dpm_solver_sample
    from instarevive_tpu_torch.diffusion.sa_solver import sa_solver_pc_sample

    if algo not in ALGOS:
        raise ValueError(f"unknown sampling algorithm {algo!r}")
    model_fn = guided_model(pipe, y, null, cfg_scale)
    with torch.inference_mode():
        if algo == "iddpm":
            return G.ddpm_sample_loop(respaced(str(step or 100)), model_fn, shape, generator, noise=x_init,
                                      clip_denoised=True)
        if algo == "ddim":
            return G.ddim_sample_loop(respaced(f"ddim{step}"), model_fn, shape, generator, noise=x_init)
        c = shape[-1]

        def eps_only(x, t):
            return model_fn(x, t)[..., :c]

        if x_init is None:
            x_init = torch.randn(shape, generator=generator, device=generator.device)
        if algo == "dpm-solver":
            if solver_order == 2 and solver_method == "multistep":
                return dpm_solver_pp_2m(eps_only, pipe.sched, x_init, steps=step)
            return dpm_solver_sample(eps_only, pipe.sched, x_init, steps=step, order=solver_order,
                                     method=solver_method)
        return sa_solver_pc_sample(eps_only, pipe.sched, x_init, generator, tau=sa_tau, steps=step,
                                   predictor_order=min(solver_order + 1, 3))


def sample_images(pipe, y, null, shape, **kw):
    """Sampled images (B, 8h, 8w, 3) in [0, 1], float32; ``kw`` as
    ``sample_latents``."""
    import torch

    z = sample_latents(pipe, y, null, shape, **kw)
    with torch.inference_mode():
        return pipe.decode(z).clamp(0.0, 1.0)


def main(argv=None) -> Optional[list]:
    args = parse_args(argv)

    import torch

    from instarevive_tpu_torch.inference import load_pipeline
    from instarevive_tpu_torch.utils.image_io import save_image

    pipe, null = load_pipeline(args)
    print("[warn] T5 is not ported: sampling with the null caption embedding", file=sys.stderr)
    b = len(args.prompt)
    y = null.expand(b, -1, -1)
    shape = latent_shape(args.prompt, args.image_size, pipe.latent_factor)
    generator = torch.Generator(device=y.device).manual_seed(args.seed)
    imgs = sample_images(pipe, y, y, shape, algo=args.sampling_algo, step=args.step, cfg_scale=args.cfg_scale,
                         solver_order=args.solver_order, solver_method=args.solver_method, sa_tau=args.sa_tau,
                         generator=generator).cpu().numpy()
    os.makedirs(args.output, exist_ok=True)
    paths = []
    for i, img in enumerate(imgs):
        path = os.path.join(args.output, f"sample_{i}_{args.sampling_algo}.png")
        save_image(img, path)
        print(path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
