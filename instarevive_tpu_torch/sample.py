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

With ``--t5_dir`` (a T5 encoder directory, ``models/t5.py``) the prompts
are encoded at the DiT's ``model_max_length``; the mask is computed and, as
in the JAX package's ``sample.py``, not handed to the DiT. Without it every
sample uses the checkpoint's learned null caption embedding.

``--seq_parallel N`` splits the DiT's tokens over N ranks and
``--pipeline_parallel S`` runs its blocks as a GPipe pipeline of S stages
(2 microbatches: the guided call's conditional and null halves); the two
exclude each other. The CLI starts its own ranks (one process a card) unless
``WORLD_SIZE`` is set; every rank runs the same sampling loop from the same
seed, only the DiT call is split, and rank 0 writes the images. Asking for
more ranks than the host has cards is an error.
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
    p.add_argument("--t5_dir", default=None, help="local T5 encoder directory (config, weights, tokenizer)")
    p.add_argument("--output", default="samples")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--sampling_algo", default="dpm-solver", choices=ALGOS)
    p.add_argument("--solver_order", type=int, default=2, help="DPM-Solver order (1-3) / SA-Solver predictor order")
    p.add_argument("--solver_method", default="multistep", choices=["multistep", "singlestep", "singlestep_fixed"])
    p.add_argument("--sa_tau", type=float, default=1.0, help="SA-Solver stochasticity (0 = ODE limit)")
    p.add_argument("--step", type=int, default=20)
    p.add_argument("--cfg_scale", type=float, default=4.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq_parallel", type=int, default=0,
                   help="split the DiT's latent tokens over N ranks (exact attention over K/V all-gathers)")
    p.add_argument("--pipeline_parallel", type=int, default=0,
                   help="run the DiT's blocks as a GPipe pipeline over S ranks; excludes --seq_parallel")
    args = p.parse_args(argv)
    if args.seq_parallel > 1 and args.pipeline_parallel > 1:
        p.error("--seq_parallel and --pipeline_parallel are mutually exclusive")
    args.world = max(args.seq_parallel, args.pipeline_parallel, 1)
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


def caption_embeddings(t5_dir: str, prompts: Sequence[str], max_length: int, device):
    """(y (B, L, D) float32, mask (B, L)) of the prompts from the T5 encoder
    at ``t5_dir``, on ``device``."""
    from instarevive_tpu_torch.models.t5 import T5Embedder

    return T5Embedder(t5_dir, model_max_length=max_length, device=device).encode(list(prompts))


def guided_model(pipe, y, null, cfg_scale: float, dit_forward=None):
    """model_fn(x, t) -> the DiT's float32 output (eps and variance channels)
    under classifier-free guidance; y, null: (B, L, C) caption embeddings;
    ``dit_forward(x, t, y, y_mask)`` in place of the DiT's own forward."""
    from instarevive_tpu_torch.diffusion.one_step import cfg_wrap

    forward = dit_forward or (lambda x, t, y, y_mask: pipe.dit(x, t, y))

    def dit(x, t, y):
        return forward(x, t.float(), y, None).float()

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
                   generator=None, x_init=None, dit_forward=None):
    """The sampled latents (B, h, w, 4), float32. ``x_init`` is the initial
    noise; else it is drawn from ``generator``, on the generator's device, as
    is every later draw of the stochastic samplers. ``dit_forward``: a
    parallel DiT forward (``parallel_forward``)."""
    import torch

    from instarevive_tpu_torch.diffusion import gaussian as G
    from instarevive_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m, dpm_solver_sample
    from instarevive_tpu_torch.diffusion.sa_solver import sa_solver_pc_sample

    if algo not in ALGOS:
        raise ValueError(f"unknown sampling algorithm {algo!r}")
    model_fn = guided_model(pipe, y, null, cfg_scale, dit_forward)
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


def parallel_forward(pipe, args, group=None):
    """The DiT forward the mesh flags ask for over ``group`` (the world by
    default), or None without them."""
    if args.world == 1:
        return None
    import torch.distributed as dist

    from instarevive_tpu_torch.parallel.pp import MICROBATCHES, PipelineDiT
    from instarevive_tpu_torch.parallel.sp import pixart_sp_forward

    group = group or dist.group.WORLD
    if args.pipeline_parallel > 1:
        return PipelineDiT(pipe.dit, group, MICROBATCHES)
    return functools.partial(pixart_sp_forward, pipe.dit, group)


def main(argv=None) -> Optional[list]:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)

    import torch

    from instarevive_tpu_torch.inference import load_pipeline
    from instarevive_tpu_torch.parallel.dist import check_cards, env_world, init_distributed, launch
    from instarevive_tpu_torch.utils.image_io import save_image

    rank = 0
    if args.world > 1:
        if env_world() == 1:  # start the ranks on this host; each runs this main under WORLD_SIZE
            check_cards(args.world, args.device)
            launch(main, argv, args.world)
            return None
        rank, world = init_distributed(args.device)
        if world != args.world:
            raise SystemExit(f"the mesh flags ask for {args.world} ranks, WORLD_SIZE is {world}")
    pipe, null = load_pipeline(args)
    dit_forward = parallel_forward(pipe, args)
    b = len(args.prompt)
    null = null.expand(b, -1, -1)
    if args.t5_dir:
        # the mask is unused, as in the JAX package (ROADMAP C16)
        y, _ = caption_embeddings(args.t5_dir, args.prompt, pipe.dit.model_max_length, null.device)
    else:
        print("[warn] no --t5_dir: sampling with the null embedding", file=sys.stderr)
        y = null
    shape = latent_shape(args.prompt, args.image_size, pipe.latent_factor)
    generator = torch.Generator(device=y.device).manual_seed(args.seed)
    imgs = sample_images(pipe, y, null, shape, algo=args.sampling_algo, step=args.step, cfg_scale=args.cfg_scale,
                         solver_order=args.solver_order, solver_method=args.solver_method, sa_tau=args.sa_tau,
                         generator=generator, dit_forward=dit_forward).cpu().numpy()
    if rank:
        return None
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
