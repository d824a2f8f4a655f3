"""Training launcher of the port (``python -m instarevive_tpu_torch.train``): DMD
distillation of the one-step generator, the stage-1 SwinIR cleaner, and the
LDM/ControlNet stack (ControlLDM and Reflow).

    python -m instarevive_tpu_torch.train --task dmd --data /path/hq --out runs/dmd \\
        --config configs/instarevive_v1.yaml --bf16 --batch_size 2 [--device cuda|cpu]
    python -m instarevive_tpu_torch.train --task swinir --data /path/hq --out runs/swinir \\
        --config configs/instarevive_v1.yaml --bf16 --batch_size 2 [--degradation realesrgan|codeformer]
    python -m instarevive_tpu_torch.train --task cldm --data /path/hq --out runs/cldm \
        --config configs/cldm.yaml --bf16 --batch_size 2 [--t_sampler loss_second_moment] [--context_npz ctx.npz]

The flags are those of the JAX package's ``train.py`` (without ``--fsdp`` and
the trace flags). Every batch of every task goes through the degradation
synthesis on the device (``--degradation``: the Real-ESRGAN two-stage program
or the CodeFormer one), which turns the clean crops into the pair
``{"hq" in [-1, 1], "lq" in [0, 1]}`` the step trains on.

``--task swinir`` trains the SwinIR cleaner to map ``lq`` to the clean image
(mean squared error), with an EMA of its parameters; a step whose gradient is
not finite is skipped: the flag stays on the device, which keeps the whole
state as it was (``utils.debug.nan_guard``).

``--task dmd`` trains three PixArt copies that start from
one initialisation: the generator (with an EMA), the fake score, and the
frozen teacher behind classifier-free guidance. Each step encodes the clean
image of the pair with the VAE under ``no_grad`` (or reads paired noise/latent
files with ``--dmd_noise_dir/--dmd_latent_dir``), takes the generator's step
(paired regression + distribution matching), then the fake score's denoising
step on the generator's sample; ``lq`` is not read, as in the JAX package.
``--bf16`` computes in bf16 from f32 master weights; ``--lowmem`` stores
optimizer moments, the EMA and the teacher in bf16 (the frozen teacher's
weights are bf16 under ``--bf16`` too: cast once, not per call).
Every DiT block is gradient-checkpointed unless the config says otherwise.

``--task cldm|reflow`` trains the SD-2.1 UNet's ControlNet (and the UNet's
decoder unless the config says ``sd_locked``) on the latents of the frozen
VAE: the clean image's, and the control latent of the frozen SwinIR's output
on ``lq``. ``cldm`` predicts eps (``--t_sampler loss_second_moment`` samples t
by importance, its state carried in the train state and the checkpoint);
``reflow`` matches the straight path's velocity. The text context is the
first array of ``--context_npz`` (its first row, repeated over the batch) or
zeros (B, 4, context_dim). Every parameter that does not train has
``requires_grad`` off before the optimizer is built; the EMA covers the
trained ones; a step whose gradient is not finite is skipped on the device.

Runs on the card by default and exits when there is none; ``--device cpu`` is
for tests. Metrics are fetched one step late, so the host never waits for
the step it has just launched.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from instarevive_tpu_torch.config import load_config
from instarevive_tpu_torch.data.dataset import ImageFolderDataset, PrefetchLoader
from instarevive_tpu_torch.data.codeformer import CodeformerDegradationConfig, degrade_batch_codeformer
from instarevive_tpu_torch.data.internal import DMDPairDataset
from instarevive_tpu_torch.data.realesrgan import RealESRGANDegradationConfig, degrade_batch, draw_degradation
from instarevive_tpu_torch.diffusion import timestep_sampler as ts_sampler
from instarevive_tpu_torch.models.unet import UNetBackbone, zero_init_
from instarevive_tpu_torch.nn.layers import set_compute_dtype
from instarevive_tpu_torch.ops.degradation import make_generators
from instarevive_tpu_torch.pipelines.build import build_pipeline, cast_weights, init_params
from instarevive_tpu_torch.train import checkpoint as ckpt
from instarevive_tpu_torch.train.cldm import ControlLDM, ControlLDMTask
from instarevive_tpu_torch.train.distill import draw_noise, make_cfg_real_fn, make_dmd_train_step, swinir_loss
from instarevive_tpu_torch.train.optim import build_optimizer, constant_with_warmup
from instarevive_tpu_torch.train.state import TrainState
from instarevive_tpu_torch.utils.debug import SimpleTimer, nan_guard
from instarevive_tpu_torch.utils.logging import LogBuffer, MetricWriter, close_logger, get_root_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", choices=["swinir", "cldm", "reflow", "dmd"], required=True)
    p.add_argument("--config", default="configs/tiny.yaml")
    p.add_argument("--data", required=True, help="HQ image folder or file list")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--crop_size", type=int, default=512)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lr_fake_multiplier", type=float, default=1.0)
    p.add_argument("--warmup", type=int, default=500)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=10.0)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "lion", "came"])
    p.add_argument("--ema_rate", type=float, default=0.9999)
    p.add_argument("--lowmem", action="store_true",
                   help="bf16 optimizer moments, bf16 EMA shadow, bf16 frozen teacher")
    p.add_argument("--remat_policy", default=None, choices=["full", "dots"],
                   help="DiT block checkpointing policy (default: the config's): 'full' recomputes a block's "
                        "forward in the backward, 'dots' keeps its Linears' outputs and recomputes the rest")
    p.add_argument("--bf16", action="store_true", help="bf16 compute from f32 master weights")
    p.add_argument("--maxt", type=int, default=400)
    p.add_argument("--cfg_scale", type=float, default=3.0)
    p.add_argument("--regression_weight", type=float, default=0.25)
    p.add_argument("--checkpointing_steps", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--degradation", default="realesrgan", choices=["realesrgan", "codeformer"],
                   help="the synthesis every batch goes through: the Real-ESRGAN two-stage program or the "
                        "CodeFormer single-stage one")
    p.add_argument("--t_sampler", default="uniform", choices=["uniform", "loss_second_moment"])
    p.add_argument("--queue_size", type=int, default=256)
    p.add_argument("--dmd_noise_dir", default=None,
                   help="paired-noise dir; with --dmd_latent_dir, regression pairs come from disk "
                        "instead of on-the-fly encoding")
    p.add_argument("--dmd_latent_dir", default=None)
    p.add_argument("--dmd_t5_dir", default=None,
                   help="per-sample caption-feature dir (.npz with caption_feature)")
    p.add_argument("--null_embed", default=None,
                   help="cached T5 null-prompt embedding: the unconditional branch of the teacher's CFG")
    p.add_argument("--context_npz", default=None,
                   help="precomputed text-encoder features for --task cldm|reflow (first array, first row)")
    return p.parse_args(argv)


def _cycle(loader) -> Iterator[Dict[str, np.ndarray]]:
    while True:  # epochs cycle forever (the loader is one epoch)
        yield from loader


class Degrader:
    """The degradation synthesis of one run: the chosen program, its
    configuration and its two generators (a CPU one for decisions and
    parameters, one on the device for noise fields), kept apart from any
    generator the training step draws from. ``filter_calls`` counts the
    ``filter2d`` calls that the draws so far imply."""

    def __init__(self, kind: str, seed: int, device: torch.device):
        self.kind = kind
        self.cfg = RealESRGANDegradationConfig() if kind == "realesrgan" else CodeformerDegradationConfig()
        self.gens = make_generators(seed, device)
        self.filter_calls = 0

    def __call__(self, hq01: torch.Tensor, draws=None) -> Dict[str, torch.Tensor]:
        """hq01: (B, H, W, 3) in [0, 1] on the device -> {"hq", "lq"}."""
        if self.kind == "codeformer":
            self.filter_calls += 1
            return degrade_batch_codeformer(self.gens, hq01, self.cfg, draws=draws)
        if draws is None:
            draws = draw_degradation(self.gens.host, self.cfg, hq01.shape[0])
        self.filter_calls += 2 + int(draws.blur2)
        return degrade_batch(self.gens, hq01, self.cfg, draws=draws)


class Task:
    """What the loop drives: ``run_step`` on a loader batch, the train
    ``states`` and the ``generators`` a checkpoint must carry."""

    states: tuple

    def __init__(self, args, device: torch.device):
        self.device = device
        self.degrade = Degrader(args.degradation, args.seed, device)
        self.on_phase = None  # set by a timing tool: called with a name as each phase of a step begins

    def mark(self, name: str) -> None:
        if self.on_phase:
            self.on_phase(name)

    def generators(self) -> Dict[str, torch.Generator]:
        return {"degrade_host": self.degrade.gens.host, "degrade_device": self.degrade.gens.device}

    def run_step(self, batch: Dict[str, np.ndarray], draws=None) -> Dict[str, torch.Tensor]:
        """One step on a loader batch ({'hq': uint8 (B,H,W,3)}): degrade it on
        the device, then train on the pair. Returns the step's metrics as
        0-dim tensors on the device."""
        self.mark("degrade")
        hq01 = torch.from_numpy(batch["hq"]).to(self.device).float() / 255.0
        return self.train_step(self.degrade(hq01, draws))

    def train_step(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class SwinIRTask(Task):
    """``--task swinir``: the SwinIR cleaner alone, its train state with an
    EMA, and one step on a degraded pair. ``--bf16`` computes in bf16 from
    f32 master weights."""

    PHASES = ("degrade", "forward", "backward", "optimizer")

    def __init__(self, args, cfg, device: torch.device, logger=None):
        super().__init__(args, device)
        pipe = build_pipeline(cfg, dtype=torch.bfloat16 if args.bf16 else None, device=device,
                              components=("swinir",), swinir_master_weights=True)
        self.pipe = init_params(pipe, seed=args.seed)
        self.model = pipe.swinir.requires_grad_(True).train()
        tx = build_optimizer(args.optimizer, constant_with_warmup(args.lr, args.warmup),
                             grad_clip_norm=args.max_grad_norm, grad_accum=args.grad_accum,
                             moment_dtype=torch.bfloat16 if args.lowmem else None)
        self.states = (TrainState.create(self.model, tx, ema=True, ema_rate=args.ema_rate),)

    def train_step(self, data: Dict[str, torch.Tensor], keep_grads: Optional[List] = None) -> Dict[str, torch.Tensor]:
        (state,) = self.states
        self.mark("forward")
        loss = swinir_loss(self.model, {"hq": (data["hq"] + 1.0) / 2.0, "lq": data["lq"]})
        self.mark("backward")
        grads = torch.autograd.grad(loss, state.params)
        self.mark("optimizer")
        metrics = {"loss": loss.detach()}
        nan_guard(state, grads, metrics)
        self.mark("end")
        if keep_grads is not None:  # for tests and the card-against-CPU check
            keep_grads.extend(grads)
        return metrics


class DMDTask(Task):
    """The three models, the two train states and one step of ``--task dmd``,
    as the launcher and the timing tool set them up."""

    def __init__(self, args, cfg, device: torch.device, logger=None):
        super().__init__(args, device)
        dit_cfg = dict(cfg.get("dit", {}) or {})
        dit_cfg.setdefault("grad_checkpoint", True)  # what makes the full-width step fit comfortably
        if args.remat_policy is not None:
            dit_cfg["remat_policy"] = args.remat_policy
        cfg = dict(cfg, dit=dit_cfg)
        dtype = torch.bfloat16 if args.bf16 else None
        self.pipe = pipe = init_params(
            build_pipeline(cfg, dtype=dtype, device=device, dit_master_weights=True), seed=args.seed)
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(args.seed)

        # three copies of one initialisation; only the generator and the fake score train
        self.gen = pipe.dit.requires_grad_(True).train()
        self.fake = copy.deepcopy(self.gen)
        self.teacher = copy.deepcopy(self.gen).requires_grad_(False).eval()
        if args.lowmem or args.bf16:
            # frozen, so casting its weights once gives what casting them in every call would;
            # --lowmem alone also makes the teacher compute in bf16
            cast_weights(self.teacher, torch.bfloat16)

        L, C = self.gen.model_max_length, self.gen.caption_channels
        self.y = torch.zeros(args.batch_size, L, C, device=device)
        if args.null_embed:
            y_null = torch.from_numpy(ckpt.load_null_embed(args.null_embed)).to(device)
        else:
            y_null = torch.zeros(L, C, device=device)
            if args.cfg_scale != 1.0 and logger is not None:
                logger.warning("cfg_scale=%.1f with no --null_embed: using a zero uncond embedding", args.cfg_scale)

        def model_fn(model):
            def fn(z, t, **cond):
                return model(z, t.float(), cond["y"])[..., : z.shape[-1]]
            return fn

        moment_dtype = torch.bfloat16 if args.lowmem else None

        def tx(lr):
            return build_optimizer(args.optimizer, constant_with_warmup(lr, args.warmup),
                                   grad_clip_norm=args.max_grad_norm, grad_accum=args.grad_accum,
                                   moment_dtype=moment_dtype)

        gen_state = TrainState.create(self.gen, tx(args.lr), ema=True, ema_rate=args.ema_rate,
                                      ema_dtype=torch.bfloat16 if args.lowmem else None)
        fake_state = TrainState.create(self.fake, tx(args.lr * args.lr_fake_multiplier), ema=False)
        self.states = (gen_state, fake_state)
        self._step = make_dmd_train_step(
            pipe.sched, model_fn(self.gen), make_cfg_real_fn(model_fn(self.teacher), y_null, args.cfg_scale),
            model_fn(self.fake), maxt=args.maxt, regression_weight=args.regression_weight,
            on_phase=self.mark,
        )

        self.pair_prefetch, self._pairs = None, None
        if args.dmd_noise_dir and args.dmd_latent_dir:
            pair_ds = DMDPairDataset(args.dmd_noise_dir, args.dmd_latent_dir, t5_dir=args.dmd_t5_dir)
            self.pair_prefetch = PrefetchLoader(pair_ds, args.batch_size, seed=args.seed)
            self._pairs = _cycle(self.pair_prefetch)

    def _fit_tokens(self, fea: np.ndarray) -> torch.Tensor:
        """(B,[1,]L,C) caption features -> (B, model_max_length, C)."""
        fea = torch.from_numpy(np.asarray(fea, np.float32)).to(self.device)
        if fea.ndim == 4:
            fea = fea[:, 0]
        L = self.gen.model_max_length
        if fea.shape[1] < L:
            fea = torch.nn.functional.pad(fea, (0, 0, 0, L - fea.shape[1]))
        return fea[:, :L]

    def generators(self) -> Dict[str, torch.Generator]:
        return {"step": self.generator, **super().generators()}

    def train_step(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One DMD step on a degraded pair, of which only the clean image is read."""
        y_step = self.y
        self.mark("encode")
        if self._pairs is not None:
            pair = next(self._pairs)
            dmd_batch = {k: torch.from_numpy(np.asarray(pair[k], np.float32)).to(self.device)
                         for k in ("noise", "latent")}
            if "txt_fea" in pair:  # real prompt embeddings from --dmd_t5_dir
                y_step = self._fit_tokens(pair["txt_fea"])
        else:
            with torch.no_grad():
                latent = self.pipe.encode((data["hq"] + 1.0) / 2.0)
            dmd_batch = {"noise": draw_noise(self.generator, latent.shape, self.device), "latent": latent}
        return self._step(*self.states, dmd_batch, self.generator, {"y": y_step})


def load_context(path: Optional[str], batch: int, context_dim: int, device) -> torch.Tensor:
    """The cldm text context: the first array of a .npz/.npy file ((L, D) or
    (N, L, D): its first row), repeated over the batch; zeros (B, 4, D)
    without a file, as the JAX package's trainer has it."""
    if path is None:
        return torch.zeros(batch, 4, context_dim, device=device)
    feat = np.load(path)
    feat = np.asarray(feat[feat.files[0]] if hasattr(feat, "files") else feat, np.float32)
    if feat.ndim == 2:
        feat = feat[None]
    return torch.from_numpy(np.repeat(feat[:1], batch, axis=0)).to(device)


class CLDMTask(Task):
    """``--task cldm|reflow``: the frozen SwinIR and VAE of the pipeline, the
    UNet and the ControlNet of ``cfg['unet']`` and ``cfg['controlnet']``
    (seeded random init, the reference's zero-initialised layers zero), one
    train state over the trained parameters with an EMA, and the
    loss-second-moment sampler's state for ``cldm`` under ``--t_sampler
    loss_second_moment``. ``states`` is (train state, sampler state or None)."""

    PHASES = ("degrade", "get_input", "forward", "backward", "optimizer")

    def __init__(self, args, cfg, device: torch.device, logger=None):
        super().__init__(args, device)
        dtype = torch.bfloat16 if args.bf16 else None
        self.pipe = init_params(build_pipeline(cfg, dtype=dtype, device=device, components=("swinir", "vae")),
                                seed=args.seed)
        with torch.device(device):
            unet, controlnet = UNetBackbone(**cfg["unet"]), UNetBackbone(**cfg["controlnet"])
        self.model = model = ControlLDM(unet, controlnet)
        init_params(model, seed=args.seed)
        zero_init_(unet), zero_init_(controlnet)
        if dtype is not None:  # f32 masters, bf16 compute
            set_compute_dtype(model, dtype)
        model.to(memory_format=torch.channels_last)
        # what trains: the ControlNet, and the UNet's decoder (output_blocks, out) unless sd_locked; off
        # before the optimizer is built, so neither autograd nor the optimizer sees the rest
        sd_locked = bool(cfg.get("sd_locked", False))
        model.requires_grad_(False)
        controlnet.requires_grad_(True)
        if not sd_locked:
            unet.output_blocks.requires_grad_(True)
            unet.out.requires_grad_(True)
        self.task = ControlLDMTask(unet, controlnet, self.pipe.vae, self.pipe.swinir, self.pipe.sched, sd_locked)
        self.context = load_context(args.context_npz, args.batch_size, int(cfg["unet"].get("context_dim", 1024)),
                                    device)
        self.reflow = args.task == "reflow"
        self.use_lsm = args.t_sampler == "loss_second_moment" and args.task == "cldm"
        self.generator = torch.Generator(device=device).manual_seed(args.seed)
        tx = build_optimizer(args.optimizer, constant_with_warmup(args.lr, args.warmup),
                             grad_clip_norm=args.max_grad_norm, grad_accum=args.grad_accum,
                             moment_dtype=torch.bfloat16 if args.lowmem else None)
        state = TrainState.create(model, tx, ema=True, ema_rate=args.ema_rate)
        lsm = ts_sampler.loss_second_moment_init(self.pipe.sched.num_timesteps, device=device) if self.use_lsm else None
        self.states = (state, lsm)

    @property
    def states(self) -> tuple:
        return self._states

    @states.setter
    def states(self, value) -> None:
        state, lsm = value  # a restored sampler state comes from the checkpoint on the CPU
        self._states = (state, None if lsm is None else {k: v.to(self.device) for k, v in lsm.items()})

    def generators(self) -> Dict[str, torch.Generator]:
        return {"step": self.generator, **super().generators()}

    def train_step(self, data: Dict[str, torch.Tensor], keep_grads: Optional[List] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One step on a degraded pair. ``draws`` hands in t and the noise
        ({'t', 'noise'} for cldm, {'t', 'z_T'} for reflow) in place of the
        generator's."""
        state, lsm = self.states
        draws = dict(draws or {})
        batch = {"hq": data["hq"], "lq": data["lq"], "context": self.context}
        self.mark("get_input")
        latents = self.task.get_input(batch)
        self.mark("forward")
        if self.reflow:
            loss, aux = self.task.reflow_loss(batch, self.generator, latents=latents, **draws)
        else:
            weights = None
            if self.use_lsm:
                draws["t"], weights = ts_sampler.loss_second_moment_sample(
                    self.generator, lsm, latents[0].shape[0], t=draws.get("t"))
            loss, aux = self.task.eps_loss(batch, self.generator, loss_weights=weights, latents=latents, **draws)
            if self.use_lsm:
                lsm = ts_sampler.loss_second_moment_update(lsm, aux["t"], aux["per_sample_loss"])
        self.mark("backward")
        grads = torch.autograd.grad(loss, state.params)
        self.mark("optimizer")
        metrics = {"loss": loss.detach(), **{k: v for k, v in aux.items() if v.ndim == 0 and k != "loss_simple"}}
        nan_guard(state, grads, metrics)
        self.states = (state, lsm)
        self.mark("end")
        if keep_grads is not None:  # for tests and the card-against-CPU check
            keep_grads.extend(grads)
        return metrics


TASKS = {"dmd": DMDTask, "swinir": SwinIRTask, "cldm": CLDMTask, "reflow": CLDMTask}


class TrainRun:
    """What ``main`` hands back: the task (models and states), the step the
    run started and ended at, and every step's metrics as floats."""

    def __init__(self, task: Task, start_step: int):
        self.task, self.start_step, self.end_step = task, start_step, start_step
        self.history = []


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: run on a machine with a card, or pass --device cpu")
    os.makedirs(args.out, exist_ok=True)
    close_logger()  # a second run in one process gets its own log file
    logger = get_root_logger(os.path.join(args.out, "train.log"))
    writer = MetricWriter(os.path.join(args.out, "tb"))
    device = torch.device(args.device)
    logger.info(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}  task: {args.task}")

    task = TASKS[args.task](args, load_config(args.config), device, logger)
    logger.info("params initialized")
    ds = ImageFolderDataset(args.data, out_size=args.crop_size, crop_type="random", seed=args.seed)
    loader = PrefetchLoader(ds, args.batch_size, seed=args.seed)
    buf = LogBuffer()
    timer = SimpleTimer(args.steps, log_interval=args.log_every)

    step_i = 0
    if args.resume:
        # params, EMA, optimizer moments, every train state, the generators' states
        # (the step's and the degradation's) and the step all round-trip; a
        # params/EMA-only checkpoint loads too
        task.states, step_i = ckpt.restore_train_state(args.resume, task.states, task.generators())
        if step_i:
            loader.fast_forward(step_i)
            if getattr(task, "pair_prefetch", None) is not None:
                task.pair_prefetch.fast_forward(step_i)
            timer = SimpleTimer(args.steps, log_interval=args.log_every, initial=step_i)
        logger.info(f"resumed full train state from {args.resume} at step {step_i}")
    logger.info("train state ready; entering loop")
    run = TrainRun(task, step_i)

    def fetch(metrics: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, float]]:
        return None if metrics is None else {k: float(v) for k, v in metrics.items() if v.ndim == 0}

    # One-step-late fetch: reading step i's scalars at once would make the host
    # wait for the step it has just launched; step i-1's are read after step i
    # is launched, so the device queue stays fed while the host loads a batch.
    pending = None
    while step_i < args.steps:
        for batch in loader:
            if step_i >= args.steps:
                break
            try:
                step_metrics = task.run_step(batch)
                metrics, pending = fetch(pending), step_metrics
            except Exception:
                try:  # an emergency full-state checkpoint before the error goes up
                    ckpt.save_train_state(os.path.join(args.out, f"crash_step_{step_i}"),
                                          task.states, task.generators(), step_i)
                    logger.exception(f"step {step_i} failed; emergency checkpoint saved")
                except Exception:
                    logger.exception(f"step {step_i} failed; emergency checkpoint unavailable")
                raise
            if metrics is not None:
                buf.update(metrics)
                run.history.append(metrics)
            step_i += 1
            msg = timer.update()
            if msg:
                avg = buf.average()
                logger.info(f"{msg}  {avg}")
                writer.scalars(step_i, avg)
            if step_i % args.checkpointing_steps == 0:
                ckpt.save_train_state(os.path.join(args.out, f"step_{step_i}"), task.states, task.generators(), step_i)
                logger.info(f"checkpoint at step {step_i}")

    if pending is not None:  # drain the late fetch
        run.history.append(fetch(pending))
        buf.update(run.history[-1])
        logger.info(f"last step  {run.history[-1]}")
    if step_i % args.checkpointing_steps == 0 and step_i:
        logger.info(f"final state already checkpointed at step_{step_i}")
    else:
        ckpt.save_train_state(os.path.join(args.out, "final"), task.states, task.generators(), step_i)
    writer.flush()
    writer.close()
    logger.info("done")
    close_logger()
    run.end_step = step_i
    return run

