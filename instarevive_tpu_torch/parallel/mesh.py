"""Device mesh, data parallelism and FSDP (``instarevive_tpu/parallel/mesh.py``).

The JAX package shards by annotation: one ``Mesh`` with axes ('data',
'fsdp'[, 'tensor']), the batch split over ('data', 'fsdp'), every parameter
split over 'fsdp' along its largest divisible axis, and XLA inserting the
collectives. Here the same mesh is a ``torch.distributed`` ``DeviceMesh``
with one process a card, and the collectives are explicit:

* ``make_mesh(data, fsdp, tensor)``: the mesh over the whole world, the JAX
  axis names and its -1 rule (``data=-1`` takes every rank that fsdp x
  tensor leaves), 'tensor' innermost;
* ``batch_slice`` / ``gather_batch`` take the place of ``shard_batch`` and
  ``batch_sharding``: a rank holds rows ``[r*b, (r+1)*b)`` of the global
  batch, and the outputs come back together along dim 0;
* ``TrainMesh`` takes the place of ``param_sharding_rules``, ``shard_params``
  and ``commit_states``. With fsdp = 1 it is data parallelism: every rank
  holds the whole model (rank 0's weights, broadcast once) and the
  gradients are averaged over the ranks by one all-reduce a dtype, which is
  what ``DistributedDataParallel`` computes (its wrapper is not used: its
  reducer hooks fire on ``.backward()``'s accumulation, and the steps take
  ``torch.autograd.grad``). With fsdp > 1 it is FSDP2: ``fully_shard`` on
  each transformer block, then on the root, as the reference's
  TRANSFORMER_BASED_WRAP does; each parameter is split along dim 0 over
  'fsdp' and replicated over 'data' when both are above 1 (HSDP). The
  optimizer and the EMA then work on the local shards
  (``train/state.py``), and the reductions that cross a shard (the global
  gradient norm, CAME's column statistics, the finite-gradient flag) go over
  the 'fsdp' group (``train/optim.py``).

``constrain_batch``, ``constrain_heads`` and ``replicate_grad`` of the JAX
package are GSPMD layout hints and have no counterpart: here every tensor
already lives on the rank that computes with it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Type

import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "fsdp", "tensor")


def mesh_shape(world: int, data: int = -1, fsdp: int = 1, tensor: int = 1) -> Tuple[int, int, int]:
    """(data, fsdp, tensor) for ``world`` ranks: ``data=-1`` takes every rank
    that fsdp x tensor leaves; the product must be the world."""
    if data == -1:
        if world % (fsdp * tensor):
            raise ValueError(f"{world} ranks not divisible by fsdp*tensor={fsdp * tensor}")
        data = world // (fsdp * tensor)
    if data * fsdp * tensor != world:
        raise ValueError(f"mesh data={data} x fsdp={fsdp} x tensor={tensor} needs {data * fsdp * tensor} ranks, "
                         f"the world has {world}")
    return data, fsdp, tensor


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, device_type: Optional[str] = None):
    """The ('data', 'fsdp', 'tensor') ``DeviceMesh`` over the whole world
    ('tensor' innermost, so a tensor group is ranks next to each other)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(dist.get_world_size(), data, fsdp, tensor)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def group_rank(group) -> Tuple[int, int]:
    """(this rank's index in ``group``, its size); (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def batch_slice(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rows ``[rank*b, (rank+1)*b)`` of a global batch of ``size*b`` rows."""
    if x.shape[0] % size:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the {size} data-parallel ranks")
    b = x.shape[0] // size
    return x.narrow(0, rank * b, b)


def gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` joined along dim 0, in rank order, on every rank
    (``x`` itself without a group)."""
    if group is None:
        return x
    size = dist.get_world_size(group)
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def gather_tokens(t: torch.Tensor, group) -> torch.Tensor:
    """(B, n, C) token shards of every rank of ``group`` joined along the
    token axis in rank order: (B, S*n, C)."""
    b, n, c = t.shape
    size = dist.get_world_size(group)
    out = gather_batch(t, group).reshape(size, b, n, c)
    return out.permute(1, 0, 2, 3).reshape(b, size * n, c)


def local_heads(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's H/t heads of a (B, H, N, d) tensor under tensor
    parallelism over ``group`` (rank r: heads [r*H/t, (r+1)*H/t)); ``t``
    itself without a group."""
    if group is None:
        return t
    r, n = dist.get_rank(group), dist.get_world_size(group)
    per = t.shape[1] // n
    return t[:, r * per:(r + 1) * per]


def _dims(mesh) -> Tuple[int, int]:
    names = mesh.mesh_dim_names or ()
    return (mesh["data"].size() if "data" in names else 1, mesh["fsdp"].size() if "fsdp" in names else 1)


class TrainMesh:
    """The data-parallel layout of one training run over a ``DeviceMesh``
    whose dims are named among ('data', 'fsdp') (``make_mesh``'s, whose
    'tensor' dim must be 1 here), or ``None`` for one process.

    ``rank``/``size`` place this process in the global batch (distinct rows
    for every rank of data x fsdp, as ``shard_batch`` splits over both axes).
    ``shard(module, blocks)`` lays a model out (before its ``TrainState`` is
    made) and ``bind(state)`` gives the state its gradient function and, under
    FSDP2, the shard group its optimizer reduces over."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.data, self.fsdp = _dims(mesh) if mesh is not None else (1, 1)
        self.size = self.data * self.fsdp
        # FSDP2 where the mesh shards: an 'fsdp' dim above 1, or a mesh of 'fsdp' alone (one rank included)
        names = mesh.mesh_dim_names if mesh is not None else ()
        self.sharded = "fsdp" in names and (self.fsdp > 1 or "data" not in names)
        self.rank, self.group = 0, None
        if mesh is not None:
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            self.rank = coord.get("data", 0) * self.fsdp + coord.get("fsdp", 0)
            # every rank of the mesh, in batch order (new_group: a call on every rank of the world)
            self.group = mesh.get_group() if mesh.ndim == 1 else dist.new_group(mesh.mesh.flatten().tolist())

    @property
    def parallel(self) -> bool:
        """A mesh was given (of one rank or more): the wrappers run."""
        return self.mesh is not None

    def _group(self, name: str):
        return self.mesh[name].get_group()

    def _fsdp_mesh(self):
        return self.mesh["data", "fsdp"] if self.data > 1 else self.mesh["fsdp"]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch."""
        return batch_slice(x, self.rank, self.size) if self.size > 1 else x

    def shard(self, module: nn.Module, blocks: Sequence[Type[nn.Module]] = ()) -> nn.Module:
        """Lay ``module`` out over the mesh, in place: FSDP2 on each submodule
        of a type in ``blocks`` and on the root when the mesh shards; otherwise
        rank 0's weights and buffers on every rank."""
        if not self.parallel:
            return module
        if self.sharded:
            from torch.distributed.fsdp import fully_shard

            mesh = self._fsdp_mesh()
            # FSDP2 shards flat, dim-0-major storage: channels-last conv weights go back to the default layout
            module.to(memory_format=torch.contiguous_format)
            for sub in list(module.modules()):
                if sub is not module and isinstance(sub, tuple(blocks)):
                    fully_shard(sub, mesh=mesh)
            fully_shard(module, mesh=mesh)
            return module
        group = self._group("data")
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                flat = t.data.contiguous()  # a channels-last weight goes through as a plain copy
                dist.broadcast(flat, src=src, group=group)
                if flat.data_ptr() != t.data.data_ptr():
                    t.data.copy_(flat)
        return module

    def bind(self, state) -> None:
        """Give ``state`` (a ``TrainState`` over a module laid out by
        ``shard``) its gradient function and shard group."""
        if not self.parallel:
            return
        if self.sharded:
            state.grad_fn = _fsdp_grads(state)
            state.shard_group, state.flag_group = self._group("fsdp"), self.group
        else:
            state.grad_fn = _allreduce_grads(state, self._group("data"), self.data)

    def mean(self, metrics: dict) -> dict:
        """The mean over the ranks of a dict of 0-dim tensors (one
        all-reduce), on the device."""
        if not self.parallel or not metrics:
            return metrics
        keys = sorted(metrics)
        stacked = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(stacked, group=self.group)
        return dict(zip(keys, (stacked / self.size).unbind()))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a batch joined back in global order."""
        if not self.parallel:
            return x
        return gather_batch(x, self.group)


def _allreduce_grads(state, group, size: int):
    """autograd.grad over the state's parameters, then their mean over the
    data-parallel group: one all-reduce a dtype, over a flat bucket made once
    (as DDP's buckets; a bucket made per step would be held past its free by
    the collective's stream). The gradients returned are views of the bucket,
    good until the next call."""
    buckets = {}

    def grads(loss: torch.Tensor) -> List[torch.Tensor]:
        params = state.module_params
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]
        for dtype in {g.dtype for g in gs}:
            idx = [i for i, g in enumerate(gs) if g.dtype == dtype]
            numels = [gs[i].numel() for i in idx]
            flat = buckets.get(dtype)
            if flat is None or flat.numel() != sum(numels):
                flat = buckets[dtype] = torch.empty(sum(numels), dtype=dtype, device=gs[idx[0]].device)
            torch.cat([gs[i].reshape(-1) for i in idx], out=flat)
            dist.all_reduce(flat, group=group)
            flat.div_(size)
            for i, part in zip(idx, flat.split(numels)):
                gs[i] = part.view_as(gs[i])
        return gs

    return grads


def _fsdp_grads(state):
    """``loss.backward()`` through FSDP2 (which reduce-scatters the mean
    gradient into each sharded parameter's ``.grad``), then the local shards."""

    def grads(loss: torch.Tensor) -> List[torch.Tensor]:
        loss.backward()
        out = []
        for p, local in zip(state.module_params, state.params):
            out.append(torch.zeros_like(local) if p.grad is None else p.grad.to_local())
            p.grad = None
        return out

    return grads


def local_tensor(p: torch.Tensor) -> torch.Tensor:
    """This rank's shard of an FSDP2 parameter (a view: writing it writes the
    parameter), or the tensor itself."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor):
        with torch.no_grad():
            return p.to_local()
    return p


def is_sharded(p: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor)


def _shard_index(p) -> Tuple[int, int]:
    """(index of this rank's chunk along dim 0, chunk count) of an FSDP2
    parameter: its place on the mesh dim its ``Shard(0)`` is on."""
    from torch.distributed.tensor import Shard

    for mesh_dim, placement in enumerate(p.placements):
        if isinstance(placement, Shard):
            return p.device_mesh.get_local_rank(mesh_dim), p.device_mesh.size(mesh_dim)
    return 0, 1


def gather_full(local: torch.Tensor, p: torch.Tensor, sharded: bool = True) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's dim-0 chunk, laid out
    as FSDP2 parameter ``p`` is (on every rank: a collective); ``local`` as it
    is for a plain ``p`` or when not ``sharded``."""
    if not is_sharded(p) or not sharded:
        return local
    from torch.distributed.tensor import DTensor

    shape = (p.shape[0],) + tuple(local.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, p.device_mesh, p.placements, run_check=False, shape=shape,
                              stride=stride).full_tensor()


def local_chunk(full: torch.Tensor, p: torch.Tensor, sharded: bool = True) -> torch.Tensor:
    """This rank's dim-0 chunk of ``full``, as FSDP2 splits parameter ``p``
    (``torch.chunk``; a rank past the last chunk holds none); ``full`` itself
    for a plain ``p`` or when not ``sharded``."""
    if not is_sharded(p) or not sharded:
        return full
    i, n = _shard_index(p)
    chunks = torch.chunk(full, n, dim=0)
    return chunks[i] if i < len(chunks) else full.new_empty((0,) + tuple(full.shape[1:]))


def all_true(ok: torch.Tensor, group) -> torch.Tensor:
    """A 0-dim bool flag that is up on every rank of ``group`` only where it
    is up on all of them (one all-reduce)."""
    flag = (~ok).to(torch.int32).reshape(1)
    dist.all_reduce(flag, group=group)
    return (flag == 0).reshape(())
