"""Build a RestorationPipeline from a config, and give it weights
(``instarevive_tpu/pipelines/build.py``).

Weights come from seeded random init (``init_params``) or from state dicts in
the reference key layout (``load_state_dicts``), such as the ones
``convert/from_jax.py`` makes from the JAX package's params.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch

from instarevive_tpu_torch.diffusion.schedules import make_schedule
from instarevive_tpu_torch.models.pixart import PixArt
from instarevive_tpu_torch.models.swinir import SwinIR
from instarevive_tpu_torch.models.vae import AutoencoderKL
from instarevive_tpu_torch.nn.layers import set_compute_dtype
from instarevive_tpu_torch.pipelines.restore import RestorationPipeline

# Consumed in f32 even under bf16 compute, as in the JAX package: the SwinIR
# bias is added to f32 scores, and the f32 adaLN tables keep the DiT's
# residual stream in f32.
KEEP_F32 = ("relative_position_bias_table", "scale_shift_table")
# Buffers the reference checkpoints store and the port computes.
COMPUTED_KEYS = ("relative_position_index", "attn_mask", "pos_embed")


def set_precision() -> None:
    """Full-f32 matmuls and convolutions on the card. PyTorch already keeps
    f32 matmuls out of TF32; cuDNN convolutions default to TF32, which keeps
    about three digits, so it is turned off too: an f32 pipeline is f32
    throughout, and bf16 compute is unaffected by either switch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cast_weights(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast the floating-point weights and buffers of ``module`` to ``dtype``
    in place, apart from the ``KEEP_F32`` tables."""
    for name, t in [*module.named_parameters(), *module.named_buffers()]:
        if t.is_floating_point() and not name.endswith(KEEP_F32):
            t.data = t.data.to(dtype)
    return module


def build_pipeline(cfg: Mapping[str, Any], dtype: Optional[torch.dtype] = None,
                   device="cpu", dit_master_weights: bool = False) -> RestorationPipeline:
    """Build the models on ``device``; ``dtype`` (e.g. torch.bfloat16) is the
    compute dtype of every matmul and conv. Norm statistics, softmax and the
    SwinIR relative-position bias stay f32. Weights are left at torch's
    default init: give them with ``init_params`` or ``load_state_dicts``.

    For inference the weights themselves are cast to ``dtype``. With
    ``dit_master_weights`` (training) the DiT keeps f32 weights and computes
    in ``dtype`` from them (``nn.layers.set_compute_dtype``), so a gradient
    reaches an f32 parameter; the frozen VAE and SwinIR are cast as before.
    Everything comes back frozen and in eval mode: the trainer turns on
    ``requires_grad`` for the DiT copies it trains."""
    set_precision()
    sw = dict(cfg.get("swinir", {}))
    vae = dict(cfg.get("vae", {}))
    dit = dict(cfg.get("dit", {}))
    sched_cfg = dict(cfg.get("schedule", {"name": "linear", "num_timesteps": 1000}))
    with torch.device(device):
        pipe = RestorationPipeline(
            swinir=SwinIR(**sw),
            vae=AutoencoderKL(**vae),
            dit=PixArt(**dit),
            sched=make_schedule(sched_cfg.pop("name", "linear"), **sched_cfg),
            maxt=int(cfg.get("maxt", 400)),
        )
    if dtype is not None:
        for module in (pipe.swinir, pipe.vae):
            cast_weights(module, dtype)
        if dit_master_weights:
            set_compute_dtype(pipe.dit, dtype)
        else:
            cast_weights(pipe.dit, dtype)
    # The VAE's and SwinIR's activations are channels-last in memory (their
    # kernels read NHWC); with the weights laid out alike, the library
    # convolutions take both as they are instead of transposing on every call.
    pipe.vae.to(memory_format=torch.channels_last)
    pipe.swinir.to(memory_format=torch.channels_last)
    return pipe.eval().requires_grad_(False)


@torch.no_grad()
def init_params(pipe: RestorationPipeline, seed: int = 0,
                generator: Optional[torch.Generator] = None) -> RestorationPipeline:
    """Seeded random init on the pipeline's device, with flax's initializer
    families: lecun-normal (truncated) weights and zero biases for every
    linear and conv layer, unit/zero norms, N(0, 1/dim) adaLN tables and
    caption embedding, trunc-normal(0.02) relative-position tables."""
    device = next(pipe.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    for name, t in [*pipe.named_parameters(), *pipe.named_buffers()]:
        if not t.is_floating_point():
            continue
        leaf = name.rsplit(".", 1)[-1]
        tmp = torch.empty(t.shape, dtype=torch.float32, device=device)
        if leaf == "relative_position_bias_table":
            torch.nn.init.trunc_normal_(tmp, 0.0, 0.02, -0.04, 0.04, generator=generator)
        elif leaf in ("scale_shift_table", "y_embedding"):
            torch.nn.init.normal_(tmp, 0.0, t.shape[-1] ** -0.5, generator=generator)
        elif leaf == "weight" and t.ndim >= 2:
            # lecun_normal: truncated at 2 sigma, rescaled to variance 1/fan_in
            std = math.sqrt(1.0 / (t[0].numel())) / 0.87962566103423978
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif leaf == "weight":
            tmp.fill_(1.0)
        else:
            tmp.zero_()
        t.copy_(tmp)
    return pipe


def load_state_dicts(pipe: RestorationPipeline, swinir: Optional[Mapping] = None,
                     vae: Optional[Mapping] = None, dit: Optional[Mapping] = None) -> RestorationPipeline:
    """Load reference-layout state dicts (arrays or tensors) into the
    models, strictly, after dropping the buffers the port computes. PixArt
    dicts in the diffusers layout are not mapped yet."""
    for module, sd in ((pipe.swinir, swinir), (pipe.vae, vae), (pipe.dit, dit)):
        if sd is None:
            continue
        if any(k.startswith("transformer_blocks.") for k in sd):
            raise NotImplementedError("diffusers-layout PixArt checkpoints are not mapped yet")
        tensors = {
            k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            for k, v in sd.items() if not k.endswith(COMPUTED_KEYS)
        }
        module.load_state_dict(tensors, strict=True)
    return pipe


def load_checkpoint(path: str) -> Mapping[str, torch.Tensor]:
    """A state dict saved with ``torch.save`` (tensors only), unwrapped from
    a top-level ``state_dict`` entry if it has one."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)
