"""Training launcher of the port (``python -m instarevive_tpu_torch.train``): DMD
distillation of the one-step generator.

    python -m instarevive_tpu_torch.train --task dmd --data /path/hq --out runs/dmd \\
        --config configs/instarevive_v1.yaml --bf16 --batch_size 2 [--device cuda|cpu]

The flags are those of the JAX package's ``train.py`` (without ``--fsdp`` and
the trace flags). ``--task dmd`` trains three PixArt copies that start from
one initialisation: the generator (with an EMA), the fake score, and the
frozen teacher behind classifier-free guidance. Each step encodes the batch
with the VAE under ``no_grad`` (or reads paired noise/latent files with
``--dmd_noise_dir/--dmd_latent_dir``), takes the generator's step (paired
regression + distribution matching), then the fake score's denoising step on
the generator's sample. ``--bf16`` computes in bf16 from f32 master weights;
``--lowmem`` stores optimizer moments, the EMA and the teacher in bf16 (the
frozen teacher's weights are bf16 under ``--bf16`` too: cast once, not per call).
Every DiT block is gradient-checkpointed unless the config says otherwise.

The degradation synthesis is not ported yet and is not run: the DMD step
reads only the clean image of a batch (``--degradation`` is accepted and has
no effect). ``--task swinir|cldm|reflow`` raise ``NotImplementedError``.

Runs on the card by default and exits when there is none; ``--device cpu`` is
for tests. Metrics are fetched one step late, so the host never waits for
the step it has just launched.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from instarevive_tpu_torch.config import load_config
from instarevive_tpu_torch.data.dataset import ImageFolderDataset, PrefetchLoader
from instarevive_tpu_torch.data.internal import DMDPairDataset
from instarevive_tpu_torch.pipelines.build import build_pipeline, cast_weights, init_params
from instarevive_tpu_torch.train import checkpoint as ckpt
from instarevive_tpu_torch.train.distill import draw_noise, make_cfg_real_fn, make_dmd_train_step
from instarevive_tpu_torch.train.optim import build_optimizer, constant_with_warmup
from instarevive_tpu_torch.train.state import TrainState
from instarevive_tpu_torch.utils.debug import SimpleTimer
from instarevive_tpu_torch.utils.logging import LogBuffer, MetricWriter, close_logger, get_root_logger

NOT_PORTED = {
    "swinir": "needs the degradation synthesis (ROADMAP A12)",
    "cldm": "needs the LDM/ControlNet trainer (ROADMAP A14)",
    "reflow": "needs the LDM/ControlNet trainer (ROADMAP A14)",
}


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
                   help="DiT block checkpointing policy (default: the config's; 'dots' is not ported)")
    p.add_argument("--bf16", action="store_true", help="bf16 compute from f32 master weights")
    p.add_argument("--maxt", type=int, default=400)
    p.add_argument("--cfg_scale", type=float, default=3.0)
    p.add_argument("--regression_weight", type=float, default=0.25)
    p.add_argument("--checkpointing_steps", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--degradation", default="realesrgan", choices=["realesrgan", "codeformer"],
                   help="accepted; the DMD step reads only the clean image")
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
    p.add_argument("--context_npz", default=None)
    return p.parse_args(argv)


def _cycle(loader) -> Iterator[Dict[str, np.ndarray]]:
    while True:  # epochs cycle forever (the loader is one epoch)
        yield from loader


class DMDTask:
    """The three models, the two train states and one step of ``--task dmd``,
    as the launcher and the timing tool set them up."""

    def __init__(self, args, cfg, device: torch.device, logger=None):
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
        self.on_phase = None  # set by a timing tool: called as each phase of a step begins
        self._step = make_dmd_train_step(
            pipe.sched, model_fn(self.gen), make_cfg_real_fn(model_fn(self.teacher), y_null, args.cfg_scale),
            model_fn(self.fake), maxt=args.maxt, regression_weight=args.regression_weight,
            on_phase=lambda name: self.on_phase and self.on_phase(name),
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

    def run_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One DMD step on a loader batch ({'hq': uint8 (B,H,W,3)}); returns
        the step's metrics as 0-dim tensors on the device."""
        y_step = self.y
        if self.on_phase:
            self.on_phase("encode")
        if self._pairs is not None:
            pair = next(self._pairs)
            dmd_batch = {k: torch.from_numpy(np.asarray(pair[k], np.float32)).to(self.device)
                         for k in ("noise", "latent")}
            if "txt_fea" in pair:  # real prompt embeddings from --dmd_t5_dir
                y_step = self._fit_tokens(pair["txt_fea"])
        else:
            hq01 = torch.from_numpy(batch["hq"]).to(self.device).float() / 255.0
            with torch.no_grad():
                latent = self.pipe.encode(hq01)
            dmd_batch = {"noise": draw_noise(self.generator, latent.shape, self.device), "latent": latent}
        return self._step(*self.states, dmd_batch, self.generator, {"y": y_step})


class TrainRun:
    """What ``main`` hands back: the task (models and states), the step the
    run started and ended at, and every step's metrics as floats."""

    def __init__(self, task: DMDTask, start_step: int):
        self.task, self.start_step, self.end_step = task, start_step, start_step
        self.history = []


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: run on a machine with a card, or pass --device cpu")
    if args.task != "dmd":
        raise NotImplementedError(f"--task {args.task} is not ported yet: {NOT_PORTED[args.task]}")

    os.makedirs(args.out, exist_ok=True)
    close_logger()  # a second run in one process gets its own log file
    logger = get_root_logger(os.path.join(args.out, "train.log"))
    writer = MetricWriter(os.path.join(args.out, "tb"))
    device = torch.device(args.device)
    logger.info(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}  task: {args.task}")

    task = DMDTask(args, load_config(args.config), device, logger)
    logger.info("params initialized")
    ds = ImageFolderDataset(args.data, out_size=args.crop_size, crop_type="random", seed=args.seed)
    loader = PrefetchLoader(ds, args.batch_size, seed=args.seed)
    buf = LogBuffer()
    timer = SimpleTimer(args.steps, log_interval=args.log_every)

    step_i = 0
    if args.resume:
        # params, EMA, optimizer moments, the fake score's state, the generator's
        # state and the step all round-trip; a params/EMA-only checkpoint loads too
        task.states, step_i = ckpt.restore_train_state(args.resume, task.states, task.generator)
        if step_i:
            loader.fast_forward(step_i)
            if task.pair_prefetch is not None:
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
                                          task.states, task.generator, step_i)
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
                ckpt.save_train_state(os.path.join(args.out, f"step_{step_i}"), task.states, task.generator, step_i)
                logger.info(f"checkpoint at step {step_i}")

    if pending is not None:  # drain the late fetch
        run.history.append(fetch(pending))
        buf.update(run.history[-1])
        logger.info(f"last step  {run.history[-1]}")
    if step_i % args.checkpointing_steps == 0 and step_i:
        logger.info(f"final state already checkpointed at step_{step_i}")
    else:
        ckpt.save_train_state(os.path.join(args.out, "final"), task.states, task.generator, step_i)
    writer.flush()
    writer.close()
    logger.info("done")
    close_logger()
    run.end_step = step_i
    return run

