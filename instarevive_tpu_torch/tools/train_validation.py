"""Training validation on a procedural distribution, the port of the root
``tools/train_validation.py``: a teacher eps-model trained here (stage A),
DMD distillation of it into a one-step generator (stage B) and Reflow
velocity matching (stage C), with loss curves and a one-step quality table
written as markdown.

    python -m instarevive_tpu_torch.tools.train_validation [--out build/train_validation.md] [--device cuda|cpu]

The data is procedural (low-frequency random fields plus oriented ramps in
[-1, 1]) and the diffusion runs in 32x32x3 image space, so PSNR and SSIM
are meaningful. At the defaults the DiT is hidden 128 over 4 heads: head dim
32, whose f32 attention runs on the card through the split-TF32 forms of K1
and K2 (``ops/attention.py``). Every JAX assert holds here too: the teacher
trains, the DMD EMA generator beats its init, Reflow trains and its EMA
beats its init. The markdown goes to ``--out`` (under ``build/`` by default);
this tool never writes ``TRAINVAL.md``, which holds the JAX package's run.

``main(argv, on_stage=None)`` returns the curves, the quality figures and
each stage's wall and step count; ``on_stage(name)`` is called as each stage
begins ('teacher', 'pairs', 'dmd', 'quality', 'reflow', 'reflow_eval') and
with 'end' (a hook for counting kernel launches by stage).
"""

from __future__ import annotations

import argparse
import copy
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_RECORD = os.path.join(REPO, "TRAINVAL.md")  # the JAX package's run: the port's tools do not write it


# ---------------------------------------------------------------------------
# the procedural distribution


def synth_draw(generator: torch.Generator, b: int, channels: int = 3) -> Tuple[torch.Tensor, ...]:
    """The draws of one batch, in the order the JAX tool splits its key:
    a (b, 4, 4, channels) normal base field, an angle theta = pi u with u
    uniform in [0, 1), (b, 1, 1), and an amplitude uniform in [0.2, 0.8),
    (b, 1, 1, 1). On ``generator``'s device."""
    device = generator.device
    base = torch.randn((b, 4, 4, channels), generator=generator, device=device)
    theta = torch.rand((b, 1, 1), generator=generator, device=device) * math.pi
    amp = 0.2 + 0.6 * torch.rand((b, 1, 1, 1), generator=generator, device=device)
    return base, theta, amp


def synth_field(base: torch.Tensor, theta: torch.Tensor, amp: torch.Tensor, size: int) -> torch.Tensor:
    """tanh(0.5 bicubic(base) + amp ramp(theta)): the base field upsampled to
    size x size (PIL's bicubic, as ``jax.image.resize(..., 'bicubic')``) plus
    an oriented gradient; (b, size, size, channels) in [-1, 1]."""
    from instarevive_tpu_torch.ops.resize import pil_resize_bicubic

    img = pil_resize_bicubic(base, (size, size))
    lin = torch.linspace(-1.0, 1.0, size, device=base.device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    ramp = (torch.cos(theta) * xx + torch.sin(theta) * yy)[..., None]
    return torch.tanh(img * 0.5 + amp * ramp)


def synth_batch(generator: torch.Generator, b: int, size: int = 32, channels: int = 3) -> torch.Tensor:
    """Procedural 'HQ' images in [-1, 1] (the JAX tool's ``synth_batch``)."""
    return synth_field(*synth_draw(generator, b, channels), size)


# ---------------------------------------------------------------------------
# models and states


def build_dit(size: int, patch: int, hidden: int, depth: int, heads: int, device, seed: int = 0):
    """The tool's DiT (PixArt in image space: 3 channels, a 4-token caption
    of width 16, MLP ratio 2), seeded random init with flax's initializer
    families, f32."""
    from instarevive_tpu_torch.models.pixart import PixArt
    from instarevive_tpu_torch.pipelines.build import init_params

    with torch.device(device):
        dit = PixArt(input_size=size, patch_size=patch, in_channels=3, hidden_size=hidden, depth=depth,
                     num_heads=heads, caption_channels=16, model_max_length=4, mlp_ratio=2.0)
    return init_params(dit, seed=seed)


def model_fn(model: torch.nn.Module, y: torch.Tensor, channels: int = 3) -> Callable[..., torch.Tensor]:
    """(x, t, **cond) -> eps: the model's first ``channels`` outputs, the
    caption ``cond['y']`` or the zero caption ``y`` cut to the batch."""

    def fn(x, t, **cond):
        return model(x, t.float(), cond.get("y", y[: x.shape[0]]))[..., :channels]

    return fn


def with_weights(model: torch.nn.Module, named: Dict[str, torch.Tensor], trainable: bool = False) -> torch.nn.Module:
    """A copy of ``model`` holding the parameter values ``named`` (by
    parameter name), in the copy's own dtypes; frozen unless ``trainable``."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(named[name])
    return out.requires_grad_(trainable).train(trainable)


def adamw(lr: float, warmup: int, clip: float, moment_dtype: Optional[torch.dtype] = None):
    from instarevive_tpu_torch.train.optim import build_optimizer, constant_with_warmup

    return build_optimizer("adamw", constant_with_warmup(lr, warmup), grad_clip_norm=clip, moment_dtype=moment_dtype)


# ---------------------------------------------------------------------------
# the steps (draws handed in, so a test can give both packages the same ones)


def teacher_step(state, eps: Callable, sched, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                 **cond) -> torch.Tensor:
    """One DDPM eps-MSE step on ``state`` (in place); returns the loss."""
    from instarevive_tpu_torch.diffusion import gaussian as G

    x_t = G.q_sample(sched, x0, t, noise)
    loss = torch.mean((eps(x_t, t, **cond) - noise) ** 2)
    state.apply_gradients(state.gradients(loss))
    return loss.detach()


def draw_teacher(generator: torch.Generator, b: int, size: int, num_timesteps: int, channels: int = 3):
    """(x0, t, noise) of one teacher step, in the JAX tool's order."""
    x0 = synth_batch(generator, b, size, channels)
    t = torch.randint(0, num_timesteps, (b,), generator=generator, device=generator.device)
    noise = torch.randn(x0.shape, generator=generator, device=generator.device)
    return x0, t, noise


def reflow_step(state, v: Callable, sched, z0: torch.Tensor, t: torch.Tensor, z_T: torch.Tensor,
                cond: Dict) -> torch.Tensor:
    """One Reflow velocity-matching step on ``state`` (in place); returns the MSE."""
    from instarevive_tpu_torch.train.distill import reflow_loss

    loss, metrics = reflow_loss(sched, v, z0, cond=cond, t=t, z_T=z_T)
    state.apply_gradients(state.gradients(loss))
    return metrics["reflow_mse"]


@torch.no_grad()
def onestep(sched, eps: Callable, noise: torch.Tensor, t: int = 400, **cond) -> torch.Tensor:
    """The one-step generation eps_to_x0 at timestep ``t``."""
    from instarevive_tpu_torch.diffusion.one_step import eps_to_x0

    tt = torch.full((noise.shape[0],), t, dtype=torch.int64, device=noise.device)
    return eps_to_x0(sched, eps(noise, tt, **cond), noise, tt)


def to01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


@torch.no_grad()
def quality(sched, eps: Callable, held_noise: torch.Tensor, held_target: torch.Tensor) -> Tuple[float, float]:
    """(mean PSNR, mean SSIM) of the one-step generation from the held-out
    noise against the teacher's 20-step samples, both mapped to [0, 1]."""
    from instarevive_tpu_torch.utils.metrics import psnr, ssim

    gen01, tgt01 = to01(onestep(sched, eps, held_noise)), to01(held_target)
    return float(psnr(gen01, tgt01).mean()), float(ssim(gen01, tgt01).mean())


def stat_dist(x: torch.Tensor, data: torch.Tensor) -> float:
    """|mean(x) - mean(data)| + |std(x) - std(data)| (population std)."""
    return float((x.mean() - data.mean()).abs() + (x.std(correction=0) - data.std(correction=0)).abs())


def thin(curve: Sequence, n: int = 10) -> List:
    """Every len // n-th point of a curve, as the JAX tool's tables."""
    return list(curve[:: max(len(curve) // n, 1)])


def resolve_out(out: str) -> str:
    """``--out`` under the repository root unless absolute; refuses the JAX
    package's ``TRAINVAL.md``."""
    path = os.path.abspath(os.path.join(REPO, out))
    if path == JAX_RECORD:
        raise SystemExit(f"--out {out}: TRAINVAL.md holds the JAX package's run; write the port's elsewhere")
    return path


def device_from(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    return torch.device(name)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/train_validation.md", help="markdown written here (under the repo root)")
    ap.add_argument("--teacher_steps", type=int, default=2000)
    ap.add_argument("--dmd_steps", type=int, default=2000)
    ap.add_argument("--reflow_steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=32, help="image size (v2: 64)")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--patch", type=int, default=4)
    ap.add_argument("--log_every", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


# ---------------------------------------------------------------------------
# the stages


def chunks(steps: int, chunk: int) -> int:
    """Chunks of ``chunk`` steps the stage runs (at least one)."""
    return max(steps // chunk, 1)


def teacher_stage(model, sched, args, y, generator):
    """Stage A: the DDPM eps-MSE teacher, AdamW 2e-4 (warmup 100, clip 1),
    EMA 0.999. Returns (the train state, the curve of (step, loss) read once
    a chunk)."""
    from instarevive_tpu_torch.train.state import TrainState

    state = TrainState.create(model, adamw(2e-4, 100, 1.0), ema=True, ema_rate=0.999)
    eps = model_fn(model, y)
    curve = []
    for c in range(chunks(args.teacher_steps, args.log_every)):
        for _ in range(args.log_every):
            loss = teacher_step(state, eps, sched, *draw_teacher(generator, args.batch, args.size,
                                                                   sched.num_timesteps))
        i = (c + 1) * args.log_every - 1
        curve.append((i, float(loss)))
        print(f"[A] {i} eps_mse={curve[-1][1]:.4f}", flush=True)
    return state, curve


@torch.no_grad()
def sample_teacher(teacher_eps: Callable, sched, noise: torch.Tensor, clip_denoised: bool = False) -> torch.Tensor:
    """The teacher's 20-step DPM-Solver++(2M) sample from ``noise``."""
    from instarevive_tpu_torch.diffusion.dpm_solver import dpm_solver_pp_2m

    return dpm_solver_pp_2m(teacher_eps, sched, noise, steps=20, clip_denoised=clip_denoised)


def pairs_stage(teacher_eps, sched, args, generator, n: int = 8):
    """The paired data: ``n`` batches of noise and the teacher's 20-step
    samples from it, (n, b, size, size, 3) each."""
    noise = torch.randn((n, args.batch, args.size, args.size, 3), generator=generator, device=generator.device)
    return noise, torch.stack([sample_teacher(teacher_eps, sched, noise[i]) for i in range(n)])


def dmd_stage(gen, fake, teacher_eps, sched, args, y, generator, pair_noise, pair_latent,
              on_chunk: Optional[Callable] = None):
    """Stage B: DMD from the teacher's weights (regression 0.25 + DM + fake
    score, maxt 400), AdamW 1e-4 (warmup 100, clip 10) for both, the
    generator's EMA 0.999. Returns (generator state, fake-score state, the
    curve of (step, regression, dm, fake_score) read once a chunk);
    ``on_chunk(step, generator state)`` is called after each chunk."""
    from instarevive_tpu_torch.train.distill import make_dmd_train_step
    from instarevive_tpu_torch.train.state import TrainState

    gen_state = TrainState.create(gen, adamw(1e-4, 100, 10.0), ema=True, ema_rate=0.999)
    fake_state = TrainState.create(fake, adamw(1e-4, 100, 10.0), ema=False)
    step = make_dmd_train_step(sched, model_fn(gen, y), teacher_eps, model_fn(fake, y), maxt=400)
    curve = []
    for c in range(chunks(args.dmd_steps, args.log_every)):
        for s in range(args.log_every):
            j = (c * args.log_every + s) % pair_noise.shape[0]
            m = step(gen_state, fake_state, {"noise": pair_noise[j], "latent": pair_latent[j]}, generator, {"y": y})
        i = (c + 1) * args.log_every - 1
        curve.append((i, float(m["regression"]), float(m["dm"]), float(m["fake_score"])))
        print(f"[B] {i} reg={curve[-1][1]:.4f}", flush=True)
        if on_chunk is not None:
            on_chunk(i, gen_state)
    return gen_state, fake_state, curve


def reflow_stage(model, sched, args, y, generator, on_chunk: Optional[Callable] = None):
    """Stage C: Reflow from the DiT's initial weights, AdamW 2e-4 (warmup
    100, clip 1), EMA 0.999. Returns (the state, the curve of (step, MSE));
    ``on_chunk(step, state)`` is called after each chunk."""
    from instarevive_tpu_torch.train.state import TrainState

    state = TrainState.create(model, adamw(2e-4, 100, 1.0), ema=True, ema_rate=0.999)
    v = model_fn(model, y)  # the 3-channel head as v
    curve = []
    for c in range(chunks(args.reflow_steps, args.log_every)):
        for _ in range(args.log_every):
            z0 = synth_batch(generator, args.batch, args.size)
            t = torch.randint(1, sched.num_timesteps, (args.batch,), generator=generator, device=generator.device)
            z_T = torch.randn(z0.shape, generator=generator, device=generator.device)
            mse = reflow_step(state, v, sched, z0, t, z_T, {"y": y})
        i = (c + 1) * args.log_every - 1
        curve.append((i, float(mse)))
        print(f"[C] {i} reflow_mse={curve[-1][1]:.4f}", flush=True)
        if on_chunk is not None:
            on_chunk(i, state)
    return state, curve


def check_teacher(curve: Sequence) -> None:
    assert curve[-1][1] < curve[0][1] * 0.7, "teacher did not train"


def main(argv=None, on_stage: Optional[Callable[[str], None]] = None) -> Dict:
    args = parse_args(argv)
    device = device_from(args.device)
    out_path = resolve_out(args.out)
    mark = on_stage or (lambda name: None)

    from instarevive_tpu_torch.diffusion.schedules import make_schedule
    from instarevive_tpu_torch.pipelines.build import set_precision
    from instarevive_tpu_torch.train.distill import reflow_sample_1step

    set_precision()  # f32 throughout: no TF32 in matmuls or convolutions
    size, b = args.size, args.batch
    sched = make_schedule("linear", 1000)
    init_model = build_dit(size, args.patch, args.hidden, args.depth, args.heads, device, seed=0)
    init = {n: p.detach().clone() for n, p in init_model.named_parameters()}
    y = torch.zeros((b, 4, 16), device=device)
    generator = torch.Generator(device=device).manual_seed(1)
    backend = "cpu" if device.type == "cpu" else f"cuda ({torch.cuda.get_device_name(device)})"
    lines = [
        "# Training validation (synthetic, self-contained; the PyTorch port)",
        "",
        f"backend: **{backend}**, image space {size}x{size}x3, "
        f"DiT({args.hidden}h/{args.depth}L/{args.heads}heads, patch "
        f"{args.patch}), batch {b}; procedural HQ distribution (low-freq "
        f"fields + ramps).",
        "",
    ]
    walls, steps = {}, {}

    # ---------------- stage A: teacher eps-model (DDPM loss) ---------------
    mark("teacher")
    t0 = time.time()
    tstate, curve_a = teacher_stage(init_model.requires_grad_(True).train(), sched, args, y, generator)
    teacher = with_weights(init_model, tstate.ema_state_dict())
    del tstate
    walls["teacher"], steps["teacher"] = time.time() - t0, chunks(args.teacher_steps, args.log_every) * args.log_every
    lines += ["## Stage A — teacher eps-model (DDPM loss)", "", "| step | eps MSE |", "|---|---|"]
    lines += [f"| {i} | {v:.4f} |" for i, v in thin(curve_a)]
    first_a, last_a = curve_a[0][1], curve_a[-1][1]
    lines += ["", f"loss {first_a:.4f} -> {last_a:.4f} "
              f"({args.teacher_steps} steps, {walls['teacher']:.0f}s, "
              f"{args.teacher_steps / walls['teacher']:.1f} steps/s)", ""]
    check_teacher(curve_a)
    teacher_eps = model_fn(teacher, y)

    # ---------------- stage B: DMD distillation into a 1-step generator ----
    mark("pairs")
    t0 = time.time()
    pair_noise, pair_latent = pairs_stage(teacher_eps, sched, args, generator)
    walls["pairs"], steps["pairs"] = time.time() - t0, pair_noise.shape[0]
    mark("dmd")
    t0 = time.time()
    gen, fake = (copy.deepcopy(teacher).requires_grad_(True).train() for _ in range(2))  # the teacher's weights
    gen_state, fake_state, curve_b = dmd_stage(gen, fake, teacher_eps, sched, args, y, generator, pair_noise,
                                               pair_latent)
    walls["dmd"], steps["dmd"] = time.time() - t0, chunks(args.dmd_steps, args.log_every) * args.log_every
    del fake_state, fake

    mark("quality")
    t0 = time.time()
    held_noise = torch.randn((b, size, size, 3), generator=generator, device=device)
    held_target = sample_teacher(teacher_eps, sched, held_noise)
    gen_ema = with_weights(teacher, gen_state.ema_state_dict())
    psnr_init, ssim_init = quality(sched, teacher_eps, held_noise, held_target)  # generator init == teacher
    psnr_ema, ssim_ema = quality(sched, model_fn(gen_ema, y), held_noise, held_target)
    walls["quality"], steps["quality"] = time.time() - t0, 1
    lines += ["## Stage B — DMD distillation (regression 0.25 + DM + fake score)",
              "", "| step | regression | dm | fake_score |", "|---|---|---|---|"]
    lines += [f"| {i} | {r:.4f} | {d:.4f} | {f:.4f} |" for i, r, d, f in thin(curve_b)]
    lines += ["", f"({args.dmd_steps} steps, {walls['dmd']:.0f}s, "
              f"{args.dmd_steps / walls['dmd']:.1f} steps/s)", "",
              "1-step generation vs teacher 20-step DPM-Solver++ on held-out noise:",
              "", "| generator | PSNR | SSIM |", "|---|---|---|",
              f"| init (= teacher weights, 1-step) | {psnr_init:.2f} | {ssim_init:.4f} |",
              f"| EMA after DMD | {psnr_ema:.2f} | {ssim_ema:.4f} |", ""]
    assert psnr_ema > psnr_init, "DMD EMA generator did not beat its init"
    del gen_state, gen, gen_ema

    # ---------------- stage C: Reflow velocity matching --------------------
    mark("reflow")
    t0 = time.time()
    rmodel = with_weights(init_model, init, trainable=True)
    rstate, curve_c = reflow_stage(rmodel, sched, args, y, generator)
    walls["reflow"], steps["reflow"] = time.time() - t0, chunks(args.reflow_steps, args.log_every) * args.log_every

    mark("reflow_eval")
    t0 = time.time()
    z_T = torch.randn((b, size, size, 3), generator=generator, device=device)
    data = synth_batch(generator, b, size)

    def reflow_gen(model):
        with torch.no_grad():
            return reflow_sample_1step(sched, model_fn(model, y), z_T, {"y": y})

    d_init = stat_dist(reflow_gen(with_weights(init_model, init)), data)
    d_ema = stat_dist(reflow_gen(with_weights(init_model, rstate.ema_state_dict())), data)
    walls["reflow_eval"], steps["reflow_eval"] = time.time() - t0, 1
    mark("end")
    lines += ["## Stage C — Reflow velocity matching (cldm.py:685-750 math)",
              "", "| step | reflow MSE |", "|---|---|"]
    lines += [f"| {i} | {v:.4f} |" for i, v in thin(curve_c)]
    first_c, last_c = curve_c[0][1], curve_c[-1][1]
    lines += ["", f"loss {first_c:.4f} -> {last_c:.4f} "
              f"({args.reflow_steps} steps, {walls['reflow']:.0f}s, "
              f"{args.reflow_steps / max(walls['reflow'], 1e-9):.1f} steps/s)", "",
              "1-step Euler generation, distribution moments vs data "
              "(|d mean| + |d std|, lower is better):", "",
              f"- init: {d_init:.4f}", f"- EMA after reflow: {d_ema:.4f}", ""]
    assert last_c < first_c * 0.9, "reflow did not train"
    assert d_ema < d_init, "reflow EMA generator did not beat its init"

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {out_path}")
    print(f"DMD EMA vs init PSNR: {psnr_ema:.2f} vs {psnr_init:.2f}")
    print(f"reflow moment dist EMA vs init: {d_ema:.4f} vs {d_init:.4f}")
    return {"curves": {"teacher": curve_a, "dmd": curve_b, "reflow": curve_c},
            "psnr": {"init": psnr_init, "ema": psnr_ema}, "ssim": {"init": ssim_init, "ema": ssim_ema},
            "reflow_moment_dist": {"init": d_init, "ema": d_ema}, "walls": walls, "steps": steps, "out": out_path}


if __name__ == "__main__":
    main()
