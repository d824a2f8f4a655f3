"""The process group and host-level helpers (``instarevive_tpu/parallel/dist.py``).

``init_distributed`` honours the environment contract the JAX package's
honours, which is also ``torchrun``'s: ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK`` and ``WORLD_SIZE``, and ``LOCAL_RANK`` for the card. On the card
the group is NCCL, one process a card on ``cuda:{LOCAL_RANK}``; on the CPU
it is gloo. Without ``WORLD_SIZE`` (or at 1) the process runs alone and no
group is made.

``launch`` is how a CLI starts its own ranks when ``WORLD_SIZE`` is not set:
``world`` processes on this host, each with the environment above and a
free port, each calling the CLI's ``main`` with the same arguments. A rank
that fails makes ``launch`` raise. Asking for more ranks than the host has
cards (``check_cards``) is an error, never a CPU run.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

WORLD_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def env_world() -> int:
    """``WORLD_SIZE`` of the environment, 1 when it is not set."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def check_cards(world: int, device: str) -> None:
    """Raise ``SystemExit`` when ``device`` is 'cuda' and this host has fewer
    than ``world`` cards: a mesh flag never falls back to the CPU."""
    if device == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"{world} ranks on the card: this host has {torch.cuda.device_count()} CUDA devices "
                         "(pass --device cpu for gloo ranks on the CPU)")


def init_distributed(device: str = "cuda", timeout_s: float = 600.0) -> Tuple[int, int]:
    """Join the process group the environment describes and return (rank,
    world). On 'cuda' the rank takes ``cuda:{LOCAL_RANK}`` as its current
    device and the group is NCCL; on 'cpu' it is gloo. Idempotent; a process
    without ``WORLD_SIZE`` (or at 1) stays alone and returns (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = env_world()
    if world <= 1:
        return 0, 1
    rank = int(os.environ["RANK"])
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        check_cards(local + 1, device)
        torch.cuda.set_device(local)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s))
    return rank, world


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size) of the process, (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return get_dist_info()[0] == 0


def broadcast_from_main(obj: Any, group=None) -> Any:
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0) if group is not None else 0, group=group)
    return box[0]


def sync_global_mean(tree: Any, group=None) -> Any:
    """The mean over the ranks of a dict (or one value) of host numbers."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    values = [None] * dist.get_world_size(group)
    dist.all_gather_object(values, tree, group=group)
    if isinstance(tree, dict):
        return {k: float(np.mean([v[k] for v in values])) for k in tree}
    return float(np.mean(values))


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, entry: Callable, argv: Sequence[str]) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        entry(list(argv))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(entry: Callable, argv: Sequence[str], world: int, port: Optional[int] = None) -> None:
    """Run ``entry(argv)`` in ``world`` new processes on this host, rank r on
    ``cuda:r`` when it asks for the card; returns when all have ended and
    raises if one failed. ``entry`` must be importable (a module-level
    ``main``)."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(world, port or free_port(), entry, list(argv)), nprocs=world,
                       start_method="spawn")
