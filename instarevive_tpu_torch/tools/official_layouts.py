"""Seeded state dicts in the official checkpoint layouts of the depth
estimators (ISL MiDaS: DPT-Hybrid / Large / B16, v2.1, v2.1-small) and of
(LLaVA-)MPT, for the tests: what ``torch.load`` gives for such a file, with
the BatchNorms and the raw (unstandardised) hybrid convolutions the port's
loaders fold, and keys a forward never reads (the ViT's final norm and
head, ``refinenet4``'s first unit). Shapes come from the port's module, so
any width the module is built at works. Values follow
``iqa_checkpoints.seeded``. No file is read or downloaded.
"""

from __future__ import annotations

from typing import Dict

import torch

from instarevive_tpu_torch.models import dpt
from instarevive_tpu_torch.tools.iqa_checkpoints import _bn, _norm, seeded


def midas(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The official state dict of a ``models.dpt`` model's architecture."""
    shapes = {}
    for key, t in model.state_dict().items():
        conv, leaf = key.rsplit(".", 1)
        bn = dpt.encoder_bn(model, conv)
        if bn is None:
            shapes[key] = tuple(t.shape)
        elif leaf == "weight":  # a bias-free convolution and its BatchNorm
            shapes[key] = tuple(t.shape)
            _bn(shapes, bn, t.shape[0])
    if isinstance(model, dpt.DPTDepthModel):
        d = model.cfg.vit_dim
        _norm(shapes, "pretrained.model.norm", d)
        shapes["pretrained.model.head.weight"], shapes["pretrained.model.head.bias"] = (1000, d), (1000,)
    f = model.scratch.refinenet4.resConfUnit2.conv1.weight.shape[0]
    for c in (1, 2):
        shapes[f"scratch.refinenet4.resConfUnit1.conv{c}.weight"] = (f, f, 3, 3)
        shapes[f"scratch.refinenet4.resConfUnit1.conv{c}.bias"] = (f,)
    return seeded(shapes, seed)


def mpt(model: torch.nn.Module, seed: int = 0, causal_lm: bool = True) -> Dict[str, torch.Tensor]:
    """An MPT state dict (under ``transformer.`` for the causal-LM wrapper)."""
    prefix = "transformer." if causal_lm else ""
    return seeded({prefix + k: tuple(t.shape) for k, t in model.state_dict().items()}, seed)
