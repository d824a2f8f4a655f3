"""GPipe pipeline parallelism of the DiT's block stack (``instarevive_tpu/parallel/pp.py``).

A group of S ranks (the JAX package's 'pipe' axis) splits the ``depth``
blocks into S stages of depth/S consecutive blocks. ``PipelineDiT`` strips
the other stages' blocks from the rank's module tree, so a rank holds only
its own: the memory lever of a DiT past one card. The batch goes through in
M microbatches: stage s takes microbatch m from stage s-1 (stage 0 from the
embedded tokens), runs its blocks and hands the activation to stage s+1 by a
point-to-point send, so the schedule is GPipe's fill and drain over M + S - 1
ticks with a bubble of (S-1)/(M+S-1). The last stage's outputs reach every
rank by one broadcast; the embedders before the blocks and the final layer
run whole on every rank (``PixArt.prepare`` / ``finish``).

Inference only, the homogeneous block stack only and no ControlNet branch, as
in the JAX package. The rank's stage modules are the cache: nothing is
stacked or copied per call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from instarevive_tpu_torch.parallel.sp import check_homogeneous

__all__ = ["PipelineDiT"]

MICROBATCHES = 2  # what both CLIs of the JAX package fix (serve.py, sample.py)


class PipelineDiT:
    """``dit``'s stage of a pipeline over ``group``, callable as the DiT
    forward: ``(x, timestep, y, y_mask=None) -> (B, H, W, out_channels)`` on
    every rank. Construction strips the other stages' blocks from ``dit``."""

    def __init__(self, dit: nn.Module, group, microbatches: int = MICROBATCHES):
        check_homogeneous(dit, "pipeline parallelism")
        if len(dit.controlnet):
            raise NotImplementedError("pipeline parallelism: the ControlNet branch is not wired")
        self.dit, self.group, self.microbatches = dit, group, int(microbatches)
        self.stage, self.stages = dist.get_rank(group), dist.get_world_size(group)
        depth = len(dit.blocks)
        if depth % self.stages:
            raise ValueError(f"depth {depth} not divisible by pipe stages {self.stages}")
        per = depth // self.stages
        dit.blocks = nn.ModuleList(list(dit.blocks)[self.stage * per:(self.stage + 1) * per])

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def __call__(self, x: torch.Tensor, timestep: torch.Tensor, y: torch.Tensor, y_mask=None) -> torch.Tensor:
        dit, s, S, M = self.dit, self.stage, self.stages, self.microbatches
        tokens, y_tokens, t6, t_emb, hw, _ = dit.prepare(x, timestep, y)
        b = tokens.shape[0]
        if b % M:
            raise ValueError(f"batch {b} not divisible by microbatches {M}")
        mb = b // M
        # a block's output dtype: the residual stream promoted by the adaLN table and t6
        table = dit.blocks[0].scale_shift_table.dtype
        dtype = torch.promote_types(tokens.dtype, torch.promote_types(table, t6.dtype))
        outs = torch.empty(tokens.shape, dtype=dtype, device=tokens.device)
        for m in range(M):
            rows = slice(m * mb, (m + 1) * mb)
            if s == 0:
                h = tokens[rows]
            else:
                h = torch.empty((mb,) + tuple(tokens.shape[1:]), dtype=dtype, device=tokens.device)
                dist.recv(h, src=self._peer(s - 1), group=self.group)
            mask = None if y_mask is None else y_mask[rows]
            for blk in dit.blocks:
                h = blk(h, y_tokens[rows], t6[rows], mask, hw)
            if s < S - 1:
                dist.send(h.contiguous(), dst=self._peer(s + 1), group=self.group)
            else:
                outs[rows] = h
        dist.broadcast(outs, src=self._peer(S - 1), group=self.group)
        return dit.finish(outs, t_emb, hw)
