"""Build a RestorationPipeline from a config, and give it weights
(``instarevive_tpu/pipelines/build.py``).

Weights come from seeded random init (``init_params``) or from state dicts
(``load_state_dicts``) in the layouts the JAX CLI loads, read from a file by
``load_checkpoint`` or made from the JAX package's params by
``convert/from_jax.py``.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from instarevive_tpu_torch.convert.checkpoint_layouts import (
    is_diffusers_pixart, pixart_keys_from_diffusers, strip_prefixes,
)
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
                   device="cuda", dit_master_weights: bool = False, swinir_master_weights: bool = False,
                   components: Optional[Sequence[str]] = None, control_depth: int = 0) -> RestorationPipeline:
    """Build the models on ``device`` (the card unless the caller asks for
    the CPU); ``dtype`` (e.g. torch.bfloat16) is the
    compute dtype of every matmul and conv. Norm statistics, softmax and the
    SwinIR relative-position bias stay f32. Weights are left at torch's
    default init: give them with ``init_params`` or ``load_state_dicts``.

    For inference the weights themselves are cast to ``dtype``. With
    ``dit_master_weights`` (training) the DiT keeps f32 weights and computes
    in ``dtype`` from them (``nn.layers.set_compute_dtype``), so a gradient
    reaches an f32 parameter; ``swinir_master_weights`` does the same for
    SwinIR; a frozen model is cast as before. ``components`` (of 'swinir',
    'vae', 'dit') builds only those models and leaves the others None, for a
    trainer that needs one of them. ``control_depth`` gives the DiT that
    many ControlNet-Half stages, which ``process(use_control=True)`` runs.
    Everything comes back frozen and in eval mode: the trainer turns on
    ``requires_grad`` for what it trains."""
    set_precision()
    sw = dict(cfg.get("swinir", {}))
    vae = dict(cfg.get("vae", {}))
    dit = dict(cfg.get("dit", {}))
    sched_cfg = dict(cfg.get("schedule", {"name": "linear", "num_timesteps": 1000}))
    want = ("swinir", "vae", "dit") if components is None else tuple(components)
    with torch.device(device):
        pipe = RestorationPipeline(
            swinir=SwinIR(**sw) if "swinir" in want else None,
            vae=AutoencoderKL(**vae) if "vae" in want else None,
            dit=PixArt(**dit, control_depth=control_depth) if "dit" in want else None,
            sched=make_schedule(sched_cfg.pop("name", "linear"), **sched_cfg),
            maxt=int(cfg.get("maxt", 400)),
            control_depth=control_depth,
        )
    if dtype is not None:
        for module, masters in ((pipe.swinir, swinir_master_weights), (pipe.vae, False), (pipe.dit, dit_master_weights)):
            if module is not None:
                (set_compute_dtype if masters else cast_weights)(module, dtype)
    # The VAE's and SwinIR's activations are channels-last in memory (their
    # kernels read NHWC); with the weights laid out alike, the library
    # convolutions take both as they are instead of transposing on every call.
    for module in (pipe.vae, pipe.swinir):
        if module is not None:
            module.to(memory_format=torch.channels_last)
    return pipe.eval().requires_grad_(False)


@torch.no_grad()
def init_params(pipe: RestorationPipeline, seed: int = 0,
                generator: Optional[torch.Generator] = None) -> RestorationPipeline:
    """Seeded random init on the pipeline's device, with flax's initializer
    families: lecun-normal (truncated) weights with the fan-in of one output
    and zero biases for every linear and conv layer (the DiT's depthwise KV
    compression ``sr``: fan-in r * r; the size embedders' Linears), unit/zero
    norms (qk-norm and the compression's too), N(0, 1/dim) adaLN tables and
    caption embedding, trunc-normal(0.02) relative-position tables; the
    ControlNet-Half projections (``before_proj``, ``after_proj``) zero, so that
    a fresh branch leaves the DiT's output as it is."""
    device = next(pipe.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    for name, t in [*pipe.named_parameters(), *pipe.named_buffers()]:
        if not t.is_floating_point():
            continue
        leaf = name.rsplit(".", 1)[-1]
        tmp = torch.empty(t.shape, dtype=torch.float32, device=device)
        if name.startswith("dit.controlnet.") and name.rsplit(".", 2)[-2] in ("before_proj", "after_proj"):
            tmp.zero_()
        elif leaf == "relative_position_bias_table":
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


def _tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


def load_state_dicts(pipe: RestorationPipeline, swinir: Optional[Mapping] = None,
                     vae: Optional[Mapping] = None, dit: Optional[Mapping] = None) -> RestorationPipeline:
    """Load state dicts (arrays or tensors) into the models in every layout
    the JAX package's CLI loads: the reference's native keys, under a
    ``module.`` / ``model.`` prefix that every key carries or none, and for the
    DiT also the diffusers layout (``convert/checkpoint_layouts.py``). Only the
    keys a model holds are taken, as the JAX importers take only the keys they
    map: buffers the port computes (relative-position indices, attention
    masks, ``pos_embed``) and, in a DiT built without ControlNet-Half, its
    ``controlnet.N.*`` keys are dropped. A DiT built with it (``control_depth``)
    loads them from a checkpoint that carries the branch and keeps its own
    (seeded) branch from one that does not, as the JAX CLI does. A key the
    model needs that the checkpoint lacks raises and names it, apart from the
    DiT's caption embedding ``y_embedder.y_embedding``, which keeps the
    model's own value."""
    for module, sd in ((pipe.swinir, swinir), (pipe.vae, vae), (pipe.dit, dit)):
        if sd is None:
            continue
        sd = strip_prefixes(sd)
        sources = None  # native key -> the checkpoint keys joined into it; None: the native layout
        if module is pipe.dit and is_diffusers_pixart(sd):
            sd = {k.replace(".base_block.", "."): v for k, v in sd.items()}
            sources = pixart_keys_from_diffusers(module.depth, len(module.controlnet))
        own_branch = module is pipe.dit and not any(k.startswith("controlnet.") for k in sd)
        tensors = {}
        for key, own in module.state_dict().items():
            parts = (key,) if sources is None else sources.get(key, (key,))
            missing = [p for p in parts if p not in sd]
            if missing and (key == "y_embedder.y_embedding" or (own_branch and key.startswith("controlnet."))):
                tensors[key] = own
            elif missing:
                raise KeyError(f"the checkpoint has no {missing[0]!r} (for the model's {key!r})")
            else:
                values = [_tensor(sd[p]) for p in parts]
                tensors[key] = values[0] if len(values) == 1 else torch.cat(values)
        module.load_state_dict(tensors, strict=True)
    return pipe


def torch_load_safe(path: str):
    """What ``torch.save`` wrote to ``path``, on the CPU. Tensors only
    (``weights_only=True``); a file that pickles other objects (a Lightning
    checkpoint's config) loads in full only under ``IR_UNSAFE_TORCH_LOAD=1``,
    since that runs code from the file."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if os.environ.get("IR_UNSAFE_TORCH_LOAD") != "1":
            raise RuntimeError(
                f"{path} needs full unpickling (weights_only=True failed: {e}). "
                "Loading it executes arbitrary code from the file; set "
                "IR_UNSAFE_TORCH_LOAD=1 only for checkpoints you trust."
            ) from e
        obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj


def load_checkpoint(path: str) -> Mapping[str, torch.Tensor]:
    """A state dict saved with ``torch.save`` (``torch_load_safe``), unwrapped
    from its container as the JAX CLI unwraps it
    (``instarevive_tpu/train/checkpoint.py``): the first of ``state_dict``,
    ``state_dict_ema``, ``model`` and ``module`` that the file holds as a
    mapping."""
    obj = torch_load_safe(path)
    if isinstance(obj, Mapping):
        for key in ("state_dict", "state_dict_ema", "model", "module"):
            if isinstance(obj.get(key), Mapping):
                return dict(obj[key])
    return dict(obj)
