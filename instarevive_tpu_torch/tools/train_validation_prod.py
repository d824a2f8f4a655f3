"""Distillation quality at the production geometry, the port of the root
``tools/train_validation_prod.py``: an XL-2-width teacher eps-model trained
here on a procedural latent distribution at 64x64x4 (512^2 pixels through
the f8 VAE), distilled by the production DMD step
(``train/distill.make_dmd_train_step``) into the one-step generator, and the
one-step generation measured against the teacher's 20-step DPM-Solver++ on
held-out noise: latent PSNR/SSIM, pixel PSNR/SSIM after a bf16 VAE decode
(shared random weights: a fixed map), and NIQE with the pristine model fitted
on the teacher's decodes.

    python -m instarevive_tpu_torch.tools.train_validation_prod [--out build/train_validation_prod.md] [--device cuda|cpu]
    python -m instarevive_tpu_torch.tools.train_validation_prod --tiny --device cpu   # every code path at toy widths

The recipe of the JAX tool: bf16 compute from f32 master weights, the DiT
blocks checkpointed under ``remat_policy='dots'``, bf16 optimizer moments
and EMA shadow, a bf16 frozen teacher, regression weight 0.25, the fake
score's learning rate 5x the generator's, maxt 400, and the teacher
function as the real score (CFG 1: the caption is a zero embedding). The
markdown is appended to ``--out`` (under ``build/`` by default); the tool
never writes ``TRAINVAL.md``.

The set-up (``Run``) and the stages are functions of their own
(``teacher_stage``, ``pairs_stage``, ``dmd_states`` with ``dmd_step_fn`` and
``dmd_stage``, ``held_targets``, ``evaluate``), which ``main`` composes with
the JAX tool's asserts: the teacher trains and, unless ``--tiny``, the
trained generator closes part of the gap to the teacher.
"""

from __future__ import annotations

import argparse
import copy
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from instarevive_tpu_torch.tools.train_validation import (
    adamw, chunks, check_teacher, device_from, onestep, resolve_out, sample_teacher, synth_draw, synth_field, thin,
    to01, with_weights,
)

CH = 4  # latent channels


def synth_latents(generator: torch.Generator, b: int, size: int, ch: int = CH) -> torch.Tensor:
    """Procedural 'VAE latents' in [-1, 1]: the toy's distribution at latent
    shape (the JAX tool's ``synth_latents``)."""
    return synth_field(*synth_draw(generator, b, ch), size)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/train_validation_prod.md", help="markdown to APPEND to")
    ap.add_argument("--tiny", action="store_true", help="CPU smoke: shrink widths/steps to minutes")
    ap.add_argument("--teacher_steps", type=int, default=2500)
    ap.add_argument("--dmd_steps", type=int, default=3000)
    ap.add_argument("--teacher_batch", type=int, default=4)
    ap.add_argument("--dmd_batch", type=int, default=2, help="per-card DMD batch")
    ap.add_argument("--pairs", type=int, default=64, help="paired (noise, teacher-sample) count for regression")
    ap.add_argument("--held", type=int, default=16, help="held-out eval samples")
    ap.add_argument("--teacher_lr", type=float, default=1e-4)
    ap.add_argument("--dmd_lr", type=float, default=2e-5,
                    help="generator lr (the reference recipe is 1e-5 over many more steps; 2e-5 makes the gap "
                         "measurable within a 3k-step run)")
    ap.add_argument("--lr_fake_multiplier", type=float, default=5.0, help="fake-score lr multiple")
    ap.add_argument("--ema_rate", type=float, default=0.999,
                    help="validation-run EMA (0.9999 barely moves in 3k steps: 0.9999^3000 = 0.74 weight on init)")
    ap.add_argument("--maxt", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=50, help="steps between metric reads")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.tiny:  # every code path at toy cost
        args.teacher_steps = min(args.teacher_steps, 200)
        args.dmd_steps = min(args.dmd_steps, 100)
        args.chunk = min(args.chunk, 20)
        args.pairs, args.held = 8, 4
        args.teacher_lr, args.dmd_lr = 2e-3, 2e-4
    return args


def geometry(tiny: bool) -> Dict:
    """The DiT's and the VAE's widths, the latent size, the caption's tokens
    and width, and NIQE's block: the shipped production config
    (``configs/instarevive_v1.yaml``: PixArt-XL-2, the SD VAE) or, with
    ``tiny``, the JAX tool's smoke widths (decoded 32^2 images: 8-pixel NIQE
    blocks)."""
    if tiny:
        return dict(dit=dict(input_size=16, patch_size=2, in_channels=CH, hidden_size=64, depth=2, num_heads=4,
                             mlp_ratio=2.0, caption_channels=32, model_max_length=8),
                    vae=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4),
                    size=16, tokens=8, cap=32, block_size=8)
    return dict(dit=dict(input_size=64, patch_size=2, in_channels=CH, hidden_size=1152, depth=28, num_heads=16,
                         mlp_ratio=4.0, caption_channels=4096, model_max_length=300),
                vae=dict(ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4, embed_dim=4),
                size=64, tokens=300, cap=4096, block_size=96)


class Run:
    """What the stages share: the schedule, the DiT (f32 master weights,
    bf16 compute under ``dots`` unless ``dtype`` says otherwise), the
    caption geometry and the generator of every draw."""

    def __init__(self, geo: Dict, device, seed: int = 0, dtype: Optional[torch.dtype] = torch.bfloat16):
        from instarevive_tpu_torch.diffusion.schedules import make_schedule
        from instarevive_tpu_torch.models.pixart import PixArt
        from instarevive_tpu_torch.nn.layers import set_compute_dtype
        from instarevive_tpu_torch.pipelines.build import init_params

        self.geo, self.device, self.seed = geo, torch.device(device), seed
        self.size, self.tokens, self.cap = geo["size"], geo["tokens"], geo["cap"]
        self.sched = make_schedule("linear", 1000)
        with torch.device(self.device):
            dit = PixArt(**geo["dit"], grad_checkpoint=True, remat_policy="dots")
        self.dit = set_compute_dtype(init_params(dit, seed=seed), dtype)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def zeros_y(self, b: int) -> torch.Tensor:
        return torch.zeros((b, self.tokens, self.cap), device=self.device)

    def eps(self, model: torch.nn.Module):
        """(x, t, **cond) -> f32 eps of ``model``; a caption of another batch
        (or none) is replaced by the zero caption."""

        def fn(x, t, **cond):
            y = cond.get("y")
            if y is None or y.shape[0] != x.shape[0]:
                y = self.zeros_y(x.shape[0])
            return model(x, t.float(), y)[..., :CH].float()

        return fn

    def randn(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)


def frozen_bf16(model: torch.nn.Module) -> torch.nn.Module:
    """A frozen copy with every weight rounded to bf16 (the JAX tool's bf16
    teacher): bf16 tensors, and the adaLN tables, which the port consumes in
    f32, rounded through bf16 and kept f32 (what JAX's promotion of a bf16
    table against f32 activations computes)."""
    from instarevive_tpu_torch.pipelines.build import cast_weights

    out = cast_weights(copy.deepcopy(model), torch.bfloat16)
    for p in out.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16).float()
    return out.requires_grad_(False).eval()


def load_f32(model: torch.nn.Module, source: torch.nn.Module) -> torch.nn.Module:
    """``model``'s parameters set to ``source``'s values, in ``model``'s own (f32) dtypes."""
    with torch.no_grad():
        for p, s in zip(model.parameters(), source.parameters()):
            p.copy_(s)
    return model


def teacher_stage(run: Run, args):
    """Stage A at production width: DDPM eps-MSE, AdamW at ``teacher_lr``
    (warmup 200, clip 1, bf16 moments), no EMA (at 0.999 the shadow keeps
    0.999^steps of the random init; the trained weights are the teacher).
    Returns (the curve of (step, loss) read once a chunk, steps run, wall)."""
    from instarevive_tpu_torch.tools.train_validation import teacher_step
    from instarevive_tpu_torch.train.state import TrainState

    b = args.teacher_batch
    state = TrainState.create(run.dit.requires_grad_(True).train(), adamw(args.teacher_lr, 200, 1.0, torch.bfloat16),
                              ema=False)
    eps, y = run.eps(run.dit), run.zeros_y(b)
    curve = []
    t0 = time.time()
    n = chunks(args.teacher_steps, args.chunk)
    for c in range(n):
        for _ in range(args.chunk):
            x0 = synth_latents(run.generator, b, run.size)
            t = torch.randint(0, run.sched.num_timesteps, (b,), generator=run.generator, device=run.device)
            loss = teacher_step(state, eps, run.sched, x0, t, run.randn(*x0.shape), y=y)
        i = (c + 1) * args.chunk - 1
        curve.append((i, float(loss)))
        print(f"[A +{time.time() - t0:.0f}s] step {i} eps_mse={curve[-1][1]:.4f}", flush=True)
    return curve, n * args.chunk, time.time() - t0


def pairs_stage(run: Run, teacher_eps, args):
    """(noise, the teacher's 20-step clipped DPM-Solver++ samples) in
    teacher batches, regrouped to DMD batches: (n, dmd_batch, size, size, 4) each."""
    b_t, b_d, s = args.teacher_batch, args.dmd_batch, run.size
    n_pb = max(args.pairs // b_t, 1)
    noise = run.randn(n_pb, b_t, s, s, CH)
    latent = torch.stack([sample_teacher(teacher_eps, run.sched, noise[i], clip_denoised=True) for i in range(n_pb)])
    noise, latent = noise.reshape(-1, s, s, CH), latent.reshape(-1, s, s, CH)
    n_pd = noise.shape[0] // b_d
    return (noise[: n_pd * b_d].reshape(n_pd, b_d, s, s, CH), latent[: n_pd * b_d].reshape(n_pd, b_d, s, s, CH))


def dmd_states(run: Run, gen, fake, args):
    """The generator's state (AdamW at ``dmd_lr``, warmup 100, clip 10, bf16
    moments, a bf16 EMA at ``ema_rate``) and the fake score's (the same at
    ``lr_fake_multiplier`` times the rate, no EMA)."""
    from instarevive_tpu_torch.train.state import TrainState

    gen_state = TrainState.create(gen, adamw(args.dmd_lr, 100, 10.0, torch.bfloat16), ema=True,
                                  ema_rate=args.ema_rate, ema_dtype=torch.bfloat16)
    fake_state = TrainState.create(fake, adamw(args.dmd_lr * args.lr_fake_multiplier, 100, 10.0, torch.bfloat16),
                                   ema=False)
    return gen_state, fake_state


def dmd_step_fn(run: Run, gen, fake, teacher, args):
    """The production DMD step: regression 0.25 + DM + fake score at
    ``maxt``, the teacher function as the real score (CFG 1)."""
    from instarevive_tpu_torch.train.distill import make_dmd_train_step

    return make_dmd_train_step(run.sched, run.eps(gen), run.eps(teacher), run.eps(fake), maxt=args.maxt,
                               regression_weight=0.25)


def dmd_stage(run: Run, gen_state, fake_state, step, pair_noise, pair_latent, args):
    """Stage B, one step a call as the trainer runs it; the metrics are read
    one chunk late, so the host never waits on the card in the loop.
    Returns (the curve of (step, regression, dm, fake_score), wall)."""
    y = run.zeros_y(args.dmd_batch)
    curve, pending = [], None
    t0 = time.time()

    def read(pi, pm):
        curve.append((pi, float(pm["regression"]), float(pm["dm"]), float(pm["fake_score"])))
        print(f"[B +{time.time() - t0:.0f}s] step {pi} reg={curve[-1][1]:.4f} dm={curve[-1][2]:.4f} "
              f"fake={curve[-1][3]:.4f}", flush=True)

    for i in range(args.dmd_steps):
        j = i % pair_noise.shape[0]
        m = step(gen_state, fake_state, {"noise": pair_noise[j], "latent": pair_latent[j]}, run.generator, {"y": y})
        if (i + 1) % args.chunk == 0:
            if pending is not None:
                read(*pending)
            pending = (i, m)
    if pending is not None:
        read(*pending)
    return curve, time.time() - t0


def build_vae(run: Run):
    """The f8 VAE at the geometry's widths, seeded (seed + 7), frozen, bf16
    weights and compute, channels-last as the pipeline builds it."""
    from instarevive_tpu_torch.models.vae import AutoencoderKL
    from instarevive_tpu_torch.pipelines.build import cast_weights, init_params

    with torch.device(run.device):
        vae = AutoencoderKL(**run.geo["vae"])
    vae = cast_weights(init_params(vae, seed=run.seed + 7), torch.bfloat16)
    return vae.to(memory_format=torch.channels_last).eval().requires_grad_(False)


@torch.no_grad()
def decode01(vae, z: torch.Tensor, b: int = 2) -> np.ndarray:
    """The decode of ``z / VAE_SCALE`` in the VAE's compute dtype, in chunks of ``b`` (a single 512^2
    decode of every held sample would hold its top-level activations at
    once), mapped to [0, 1], on the host; a last partial chunk is dropped,
    as in the JAX tool."""
    from instarevive_tpu_torch.pipelines.restore import VAE_SCALE

    n = (z.shape[0] // b) * b
    outs = [torch.clamp((vae.decode(z[i:i + b] / VAE_SCALE).float() + 1.0) / 2.0, 0.0, 1.0) for i in range(0, n, b)]
    return torch.cat(outs).cpu().numpy()


def niqe_mean(images: np.ndarray, pris, block_size: int) -> float:
    from instarevive_tpu_torch.utils.niqe import niqe

    return float(np.mean([niqe(np.asarray(im), pris, block_size) for im in images]))


def evaluate(run: Run, vae, rows, held: torch.Tensor, held_tgt: torch.Tensor, maxt: int, block_size: int):
    """Each row's (name, eps) one-step generation from ``held`` against the
    teacher's 20-step ``held_tgt``: latent PSNR/SSIM, pixel PSNR/SSIM after
    the shared decode, NIQE with the pristine model fitted on the teacher's
    decodes. Returns ({name: (latent PSNR, latent SSIM, pixel PSNR, pixel
    SSIM, NIQE)}, the teacher's NIQE self-score)."""
    from instarevive_tpu_torch.utils.metrics import psnr, ssim
    from instarevive_tpu_torch.utils.niqe import _to_gray_255, fit_pristine_model

    tgt_lat, tgt_pix = to01(held_tgt), decode01(vae, held_tgt)
    pris = fit_pristine_model([_to_gray_255(np.asarray(im)) for im in tgt_pix], block_size)
    niqe_teacher = niqe_mean(tgt_pix, pris, block_size)
    tgt_pix_t = torch.from_numpy(tgt_pix)
    results = {}
    for name, eps in rows:
        gen = onestep(run.sched, eps, held, maxt)
        g_lat, g_pix = to01(gen), decode01(vae, gen)
        g_pix_t = torch.from_numpy(g_pix)
        results[name] = (float(psnr(g_lat, tgt_lat).mean()), float(ssim(g_lat, tgt_lat).mean()),
                         float(psnr(g_pix_t, tgt_pix_t[: len(g_pix)]).mean()),
                         float(ssim(g_pix_t, tgt_pix_t[: len(g_pix)]).mean()), niqe_mean(g_pix, pris, block_size))
    return results, niqe_teacher


def held_targets(run: Run, teacher_eps, held: torch.Tensor, b_t: int) -> torch.Tensor:
    """The teacher's clipped 20-step samples from ``held`` in teacher batches."""
    n_hb = max(held.shape[0] // b_t, 1)
    return torch.cat([sample_teacher(teacher_eps, run.sched, held[i * b_t:(i + 1) * b_t], clip_denoised=True)
                      for i in range(n_hb)])


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = device_from(args.device)
    out_path = resolve_out(args.out)
    from instarevive_tpu_torch.pipelines.build import set_precision

    set_precision()
    geo = geometry(args.tiny)
    size, tokens, cap, block_size = geo["size"], geo["tokens"], geo["cap"], geo["block_size"]
    dit_kw = geo["dit"]
    t0_all = time.time()
    run = Run(geo, device, seed=args.seed)
    n_params = sum(p.numel() for p in run.dit.parameters())
    print(f"[init +{time.time() - t0_all:.0f}s] DiT params: {n_params / 1e6:.1f}M "
          f"(geometry {size}x{size}x{CH} latents == {size * 8}^2 pixels)", flush=True)
    backend = "cpu" if device.type == "cpu" else f"cuda ({torch.cuda.get_device_name(device)})"
    lines = [
        "",
        "# Production-geometry stage B "
        f"(XL-2{' tiny-smoke' if args.tiny else ''}, {size * 8}² via {size}×{size}×{CH} latents; the PyTorch port)",
        "",
        f"backend: **{backend}**; DiT {dit_kw['hidden_size']}h/{dit_kw['depth']}L/{dit_kw['num_heads']}heads patch "
        f"{dit_kw['patch_size']} ({n_params / 1e6:.0f}M params), caption tokens {tokens}×{cap}; bf16 compute, "
        "remat 'dots', bf16 moments/EMA/teacher. Teacher trained here on a procedural latent distribution "
        "(a stand-in for the pretrained PixArt teacher).",
        "",
    ]

    # ---------------- stage A: teacher eps-model at production width -------
    curve_a, steps_a, dt_a = teacher_stage(run, args)
    teacher = frozen_bf16(run.dit)
    lines += ["## Stage A — teacher eps-model (DDPM loss, XL-2 width)", "", "| step | eps MSE |", "|---|---|"]
    lines += [f"| {i} | {v:.4f} |" for i, v in thin(curve_a)]
    lines += ["", f"loss {curve_a[0][1]:.4f} -> {curve_a[-1][1]:.4f} ({steps_a} steps, "
              f"{dt_a:.0f}s, {steps_a / dt_a:.1f} steps/s)", ""]
    check_teacher(curve_a)

    # ---------------- teacher pairs, then stage B: DMD ---------------------
    teacher_eps = run.eps(teacher)
    t0 = time.time()
    pair_noise, pair_latent = pairs_stage(run, teacher_eps, args)
    print(f"[pairs +{time.time() - t0_all:.0f}s] {pair_noise.shape[0] * args.dmd_batch} teacher pairs "
          f"({time.time() - t0:.0f}s)", flush=True)
    gen = load_f32(run.dit, teacher)  # the trained module, its weights now the bf16 teacher's
    fake = copy.deepcopy(gen)
    gen_state, fake_state = dmd_states(run, gen, fake, args)
    curve_b, dt_b = dmd_stage(run, gen_state, fake_state, dmd_step_fn(run, gen, fake, teacher, args), pair_noise,
                              pair_latent, args)
    del fake_state, fake
    lines += ["## Stage B — DMD distillation (production step: regression 0.25 + DM + fake score, lr "
              f"{args.dmd_lr:g}, maxt {args.maxt})", "",
              "| step | regression | dm | fake_score |", "|---|---|---|---|"]
    lines += [f"| {i} | {r:.4f} | {d:.4f} | {f:.4f} |" for i, r, d, f in thin(curve_b)]
    lines += ["", f"({args.dmd_steps} steps, {dt_b:.0f}s, {args.dmd_steps / dt_b:.2f} steps/s wall)", ""]

    # ---------------- eval: held-out noise, 1-step vs teacher 20-step ------
    held = run.randn(args.held, size, size, CH)
    held_tgt = held_targets(run, teacher_eps, held, args.teacher_batch)
    held = held[: held_tgt.shape[0]]
    ema = with_weights(gen, gen_state.ema_state_dict())  # the bf16 shadow as f32 weights, frozen
    del gen_state  # the moments: the decodes below fit beside the generator
    rows = [("init (= teacher weights, 1-step)", teacher_eps), ("trained 1-step (raw params)", run.eps(gen)),
            ("trained 1-step (EMA)", run.eps(ema))]
    results, niqe_teacher = evaluate(run, build_vae(run), rows, held, held_tgt, args.maxt, block_size)
    lines += ["1-step generation vs teacher 20-step DPM-Solver++ on "
              f"{held.shape[0]} held-out noises (latent PSNR/SSIM on the diffusion tensors; pixel PSNR/SSIM + NIQE "
              "after the shared f8 VAE decode; NIQE pristine model fit on the teacher's decoded outputs — teacher "
              f"self-score {niqe_teacher:.2f}):", "",
              "| generator | latent PSNR | latent SSIM | pixel PSNR | pixel SSIM | NIQE |", "|---|---|---|---|---|---|"]
    for name, (lp, ls, pp, ps, nq) in results.items():
        lines += [f"| {name} | {lp:.2f} | {ls:.4f} | {pp:.2f} | {ps:.4f} | {nq:.2f} |"]
        print(f"[eval +{time.time() - t0_all:.0f}s] {name}: latent {lp:.2f}/{ls:.4f} pixel {pp:.2f}/{ps:.4f} "
              f"NIQE {nq:.2f}", flush=True)
    lines += ["", f"total wall {time.time() - t0_all:.0f}s", ""]

    init_psnr = results[rows[0][0]][0]
    best = max(results[rows[1][0]][0], results[rows[2][0]][0])
    if args.tiny:
        # the smoke runs the code path, not convergence: early DMD degrades before the fake score has learned
        # the generator's distribution
        print(f"tiny smoke: best {best:.2f} vs init {init_psnr:.2f} latent PSNR (no assert at smoke scale)")
    else:
        assert best > init_psnr, (
            f"DMD generator did not close the gap: best {best:.2f} vs init {init_psnr:.2f} latent PSNR")

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "a") as f:
        f.write("\n".join(lines))
    print(f"appended to {out_path}")
    return {"curves": {"teacher": curve_a, "dmd": curve_b}, "results": results, "niqe_teacher": niqe_teacher,
            "walls": {"teacher": dt_a, "dmd": dt_b, "total": time.time() - t0_all}, "out": out_path}


if __name__ == "__main__":
    main()
