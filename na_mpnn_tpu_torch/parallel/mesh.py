"""Device mesh on ``torch.distributed`` (port of the JAX package's
``parallel/mesh.py``).

A mesh has two axes, ``data`` (D) and ``graph`` (G), over a world of D*G
processes, one per device. Rank ``r`` sits at ``(d, g) = (r // G, r % G)``:
a graph row is G consecutive ranks. The batch is split over ``data``; with
G > 1 the residues of each structure are also split over ``graph``, and the
edge-partitioned forward (``graph_parallel.py``) all-gathers node tables
along the graph row. The gradient is summed over the whole world.

The process group runs NCCL for CUDA devices and gloo for the CPU. It starts
from a ``FileStore`` (a file every process can reach) or from the
environment that ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``); nothing else is reached. A group that fails to
start raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place on a (data, graph) mesh and its two groups."""
    data: int
    graph: int
    rank: int
    device: torch.device
    graph_group: object    # this rank's graph row: ranks d*G .. d*G + G-1
    data_group: object     # this rank's data column: ranks g, G+g, ...

    @property
    def size(self) -> int:
        return self.data * self.graph

    @property
    def data_index(self) -> int:
        return self.rank // self.graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.graph


def initialize_distributed(world_size: int, rank: int, device="cuda",
                           init_file: Optional[str] = None):
    """Start the default process group: NCCL for a CUDA ``device``, gloo
    for the CPU; from a ``FileStore`` at ``init_file``, else from the
    environment (``torchrun``). Each process calls it once, before
    ``make_mesh``; on a card, after ``torch.cuda.set_device``."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if init_file is not None:
        store = dist.FileStore(str(init_file), world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size)


def make_mesh(data: Optional[int] = None, graph: int = 1,
              device="cuda") -> Mesh:
    """The (data, graph) mesh over the initialised world; ``data`` defaults
    to world / graph. Every rank calls it with the same arguments (it
    creates every graph row's and data column's group, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // graph
    if data * graph != world:
        raise ValueError(f"mesh ({data}, {graph}) needs {data * graph} "
                         f"processes, the world has {world}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rows = [dist.new_group(list(range(d * graph, (d + 1) * graph)))
            for d in range(data)]
    cols = [dist.new_group(list(range(g, world, graph))) for g in range(graph)]
    return Mesh(data, graph, rank, device, rows[rank // graph],
                cols[rank % graph])


def batch_sharding(mesh: Mesh, B: int, L: int, shard_length: bool = False):
    """This rank's (rows, residues) slices of a ``[B, L, ...]`` batch: the
    B/D rows of its data index and, with ``shard_length``, the L/G residues
    of its graph index. Raises unless the axes divide evenly."""
    if B % mesh.data:
        raise ValueError(f"batch of {B} rows does not split over "
                         f"data={mesh.data}")
    b = B // mesh.data
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    if not shard_length or mesh.graph == 1:
        return rows, slice(None)
    if L % mesh.graph:
        raise ValueError(f"length {L} does not split over graph={mesh.graph}")
    n = L // mesh.graph
    return rows, slice(mesh.graph_index * n, (mesh.graph_index + 1) * n)


def shard_batch(batch: Dict, mesh: Mesh, shard_length: bool = True) -> Dict:
    """This rank's part of a batch (numpy arrays or tensors): every array
    of rank >= 1 is cut to its data rows, every array of rank >= 2 also to
    its residues (with ``shard_length``); other values pass through."""
    B, L = batch["S"].shape[:2]
    rows, res = batch_sharding(mesh, B, L, shard_length)
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) == 0:
            out[k] = v
            continue
        v = v[rows] if v.ndim == 1 else v[rows, res]
        out[k] = (v.contiguous() if isinstance(v, torch.Tensor)
                  else np.ascontiguousarray(v))
    return out


def all_gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[B/D, ...]`` rows of this rank's data column -> ``[B, ...]`` in data
    order; identity at D = 1 (no gradient)."""
    if mesh.data == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, dim=0)


def replicated(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Make ``tensor`` the same on every rank: rank 0's values, in place."""
    if mesh.size > 1:
        dist.broadcast(tensor, src=0)
    return tensor


def sync_batch_length(np_batch: Dict, mesh: Mesh) -> Dict:
    """Re-pad a host batch to the longest L over the world, for ranks that
    collate their rows independently (each buckets its own longest
    structure); one small all-reduce."""
    from ..train.collate import repad_length

    if mesh.size == 1:
        return np_batch
    L = torch.tensor([int(np_batch["S"].shape[1])], device=mesh.device)
    dist.all_reduce(L, op=dist.ReduceOp.MAX)
    return repad_length(np_batch, int(L))
