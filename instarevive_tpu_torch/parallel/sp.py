"""Sequence parallelism of the DiT's tokens (``instarevive_tpu/parallel/sp.py``).

The latent tokens are split over the ranks of a group (the JAX package's
'seq' axis). Every rank runs the whole block stack on its own tokens, with
the ``PixArtBlock`` modules it already holds; each self-attention gathers K
and V of every rank's tokens (``models/pixart``'s ``sp_group``), so the local
queries attend over the exact global sequence: two (B, N, D) all-gathers a
block, and the attention kernel runs on (B, H, N/S, N) plain local tensors.
Cross-attention, the MLP and adaLN stay local. The embedders before the
blocks and the final layer run whole on every rank (``PixArt.prepare`` /
``finish``), after the tokens are gathered back.

The token count N = (H/p)(W/p) must be a multiple of the group size S; the
homogeneous full-attention stack only (no KV compression, no windows, which
are spatial-global operations) and no micro-conditioning, as in the JAX
package.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from instarevive_tpu_torch.parallel.mesh import gather_tokens

__all__ = ["check_homogeneous", "pixart_sp_forward"]


def check_homogeneous(dit, what: str) -> None:
    """Raise where the sequence- and pipeline-parallel forwards are not
    wired: micro-conditioning, KV compression or windowed blocks."""
    if dit.micro_condition:
        raise NotImplementedError(f"{what}: micro_condition path not wired")
    if any(b.attn.sampling is not None or b.attn.window_size for b in dit.blocks):
        raise NotImplementedError(
            f"{what} needs the homogeneous full-attention stack (no per-block kv-compression / window attention)")


@contextlib.contextmanager
def _seq_group(blocks, group):
    for b in blocks:
        b.attn.sp_group = group
    try:
        yield
    finally:
        for b in blocks:
            b.attn.sp_group = None


def pixart_sp_forward(dit, group, x: torch.Tensor, timestep: torch.Tensor, y: torch.Tensor, y_mask=None):
    """PixArt forward with the latent tokens split over ``group``; the whole
    output on every rank. The weights are every rank's own whole copy."""
    check_homogeneous(dit, "sequence parallelism")
    tokens, y_tokens, t6, t_emb, hw, _ = dit.prepare(x, timestep, y)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    b, n, _ = tokens.shape
    if n % size:
        raise ValueError(f"{n} tokens not divisible by seq shards {size}")
    local = tokens.narrow(1, rank * (n // size), n // size)
    with _seq_group(dit.blocks, group):
        for blk in dit.blocks:
            local = blk(local, y_tokens, t6, y_mask, hw)
    return dit.finish(gather_tokens(local, group), t_emb, hw)
