"""Megatron tensor parallelism of the DiT blocks (``instarevive_tpu/parallel/tp.py``).

Layout of every ``PixArtBlock`` (hidden c, heads H, tensor size t), as in
the JAX package:

* ``attn.qkv``, ``cross_attn.q_linear`` and ``cross_attn.kv_linear`` stay
  whole on every rank: their packed [q|k|v] output cannot be cut by heads
  without changing the checkpoint layout. Each rank then keeps its H/t heads
  of q, k and v (``models/pixart``'s ``tp_group``) and runs the attention
  kernel on them as plain local tensors. (The JAX package turns its Pallas
  kernel off under TP, which GSPMD cannot partition; here nothing is
  partitioned behind the kernel's back.)
* ``attn.proj``, ``cross_attn.proj`` and ``mlp.fc2`` are row-parallel: each
  rank holds the columns of its inputs, the partial products are summed by
  one all-reduce (in f32), and the bias is added once: by rank 0's product,
  in the same fused call, so a group of one rank computes what the plain
  layer does, bit for bit.
* ``mlp.fc1`` is column-parallel with its bias; the GELU stays local.

That is three all-reduces a block. ``shard_params_tp`` cuts a one-card state
dict into a rank's part with the keys unchanged, ``gather_params_tp`` joins
the parts back, and ``tp_dit`` lays a built DiT out in place. The row-parallel
layer serves inference: its all-reduce records no gradient.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from instarevive_tpu_torch.nn.layers import Linear

__all__ = ["RowParallelLinear", "shard_params_tp", "gather_params_tp", "tp_dit"]

_ROW = re.compile(r"(^|\.)((attn|cross_attn)\.proj|mlp\.fc2)\.weight$")
_COL = re.compile(r"(^|\.)mlp\.fc1\.(weight|bias)$")


class RowParallelLinear(Linear):
    """A ``Linear`` that holds a slice of its input features: the partial
    products (rank 0's with the bias) summed over ``group``, in f32 when the
    group has several ranks, in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, group, device=None):
        super().__init__(in_features, out_features, device=device)
        self.group = group
        self.first = dist.get_rank(group) == 0
        self.size = dist.get_world_size(group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.weight.dtype
        part = F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype) if self.first else None)
        if self.size == 1:
            dist.all_reduce(part, group=self.group)
            return part
        total = part.float()
        dist.all_reduce(total, group=self.group)
        return total.to(dtype)


def _cut(t: torch.Tensor, rank: int, size: int, dim: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} is not a multiple of the {size} tensor ranks")
    per = t.shape[dim] // size
    return t.narrow(dim, rank * per, per)


def shard_params_tp(sd: Mapping[str, torch.Tensor], rank: int, size: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank`` of ``size``'s part of a one-card DiT state dict, keys as
    they are: row-parallel weights cut along their inputs, ``mlp.fc1`` along
    its outputs, the rest whole."""
    out = {}
    for k, v in sd.items():
        if _ROW.search(k):
            out[k] = _cut(v, rank, size, 1)
        elif _COL.search(k):
            out[k] = _cut(v, rank, size, 0)
        else:
            out[k] = v
    return out


def gather_params_tp(parts: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The one-card state dict of every rank's ``shard_params_tp`` part, in
    rank order."""
    out = {}
    for k in parts[0]:
        if _ROW.search(k):
            out[k] = torch.cat([p[k] for p in parts], dim=1)
        elif _COL.search(k):
            out[k] = torch.cat([p[k] for p in parts], dim=0)
        else:
            out[k] = parts[0][k]
    return out


@torch.no_grad()
def tp_dit(dit: nn.Module, group) -> nn.Module:
    """Lay out every ``PixArtBlock`` of a built DiT (ControlNet-Half's copied
    blocks too) for tensor parallelism over ``group``, in place: each block
    takes this rank's ``shard_params_tp`` part of its own state dict, the
    layers whose weight it cuts along the inputs become ``RowParallelLinear``,
    and the attention modules get the group. Returns ``dit``."""
    from instarevive_tpu_torch.models.pixart import PixArtBlock

    rank, size = dist.get_rank(group), dist.get_world_size(group)
    for blk in [m for m in dit.modules() if isinstance(m, PixArtBlock)]:
        if blk.attn.num_heads % size:
            raise ValueError(f"{blk.attn.num_heads} heads are not a multiple of the {size} tensor ranks")
        full = blk.state_dict()
        part = shard_params_tp(full, rank, size)
        for key in full:
            if not (_ROW.search(key) or _COL.search(key)):
                continue
            path, _, attr = key.rpartition(".")
            layer = blk.get_submodule(path)
            if _ROW.search(key):
                parent, _, name = path.rpartition(".")
                new = RowParallelLinear(part[key].shape[1], layer.out_features, group, device=layer.weight.device)
                new.bias = nn.Parameter(part[f"{path}.bias"].clone(), requires_grad=False)
                new.compute_dtype = layer.compute_dtype
                setattr(blk.get_submodule(parent), name, new)
                layer = new
            elif attr == "weight":
                layer.out_features = part[key].shape[0]
            # a copy of its own, so the one-card tensor is freed
            setattr(layer, attr, nn.Parameter(part[key].clone(memory_format=torch.contiguous_format),
                                              requires_grad=False))
        blk.attn.tp_group = blk.cross_attn.tp_group = group
    return dit
