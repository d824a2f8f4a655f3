"""LoRA on state dicts (``instarevive_tpu/train/lora.py``).

Low-rank adapters on chosen 2-D linear weights, trained while the base stays
frozen and merged at apply time: W' = W + scale * up @ down, with ``down``
(r, d_in) drawn N(0, 1) / r and ``up`` (d_out, r) zero, so the first delta is
zero. A weight's adapter is ``{"down", "up"}`` under its module's name. In the
JAX package's (in, out) kernel layout the same adapter is a = downᵀ, b = upᵀ.

``DEFAULT_PATTERN`` picks, in torch names, the layers the JAX package's
pattern picks in flax paths: the attention projections (``attn1/2.to_q``,
``to_k``, ``to_v``, ``to_out.0``), the GEGLU ``proj`` and the ResBlocks'
embedding projection (``emb_layers.1``, flax ``emb_proj``), and the DiT's
``q_linear``, ``kv_linear``, ``qkv`` and ``proj``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch

DEFAULT_PATTERN = r".*(attn1|attn2|attn)\.(to_q|to_k|to_v|to_out\.0)$|.*(q_linear|kv_linear|qkv|proj|emb_layers\.1)$"

Lora = Dict[str, Dict[str, torch.Tensor]]


def init_lora(generator: Optional[torch.Generator], state_dict: Mapping[str, torch.Tensor], rank: int = 64,
              pattern: str = DEFAULT_PATTERN) -> Lora:
    """Adapters for every 2-D ``weight`` whose module name matches ``pattern``,
    rank ``min(rank, d_in, d_out)``; lora_rank 64 is ``configs/cldm.yaml``'s."""
    regex = re.compile(pattern)
    lora: Lora = {}
    for name, w in state_dict.items():
        if not name.endswith(".weight") or w.ndim != 2:
            continue
        module = name[: -len(".weight")]
        if not regex.match(module):
            continue
        d_out, d_in = w.shape
        r = min(rank, d_in, d_out)
        down = torch.randn(r, d_in, generator=generator, device=w.device) / r
        lora[module] = {"down": down, "up": torch.zeros(d_out, r, device=w.device)}
    return lora


def merge_lora(state_dict: Mapping[str, torch.Tensor], lora: Lora, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """A new state dict with W + scale * up @ down on the adapted weights
    (differentiable in the adapters); the others are the same tensors."""
    merged = dict(state_dict)
    for module, ad in lora.items():
        w = merged[module + ".weight"]
        merged[module + ".weight"] = w + scale * (ad["up"] @ ad["down"]).to(w.dtype)
    return merged


def count_lora_params(lora: Lora) -> int:
    return sum(t.numel() for ad in lora.values() for t in ad.values())
