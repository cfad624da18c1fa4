"""Process groups for multi-device certification (port of
certifyingfacerecognition_tpu/parallel/mesh.py).

One process per device (one per GPU, or per CPU process with gloo), not
one process over its local devices. The ranks form the JAX package's 2-D
(mc, id) mesh in its order, ``rank = mc * n_id + id``:

  * ``mc``: the Monte-Carlo batch is split over these ranks; their class
    counts are summed by an all-reduce over ``mc_group`` (the ranks that
    share an id index);
  * ``id``: the gallery rows are split over these ranks; each finds its
    shard's nearest identity and an all-gather over ``id_group`` (the
    ranks that share an mc index) picks the global one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (mc, id) mesh and its two groups."""

    n_mc: int
    n_id: int
    mc: int
    id: int
    mc_group: Optional[object] = None
    id_group: Optional[object] = None


def rank_coords(rank: int, n_id: int) -> Tuple[int, int]:
    """(mc, id) of a rank: the JAX package's get_2d_mesh reshapes the
    device list to [n_mc, n_id]."""
    return rank // n_id, rank % n_id


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> torch.device:
    """Join (or form) the process group; returns this rank's device.

    With ``coordinator_address`` (host:port of rank 0), the group is
    ``num_processes`` processes and this one is ``process_id``. Without
    it, torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) describes the group; when that is not set either, the
    group is this process alone. The backend is NCCL on CUDA (one GPU per
    rank: LOCAL_RANK, else the rank modulo the local GPU count) and gloo
    on the CPU; a group that fails to form raises."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator-address needs --num-processes "
                             "and --process-id")
        rank, world = process_id, num_processes
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=world, rank=rank)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        kwargs = dict(init_method="env://", world_size=world, rank=rank)
    else:
        rank, world = 0, 1
        kwargs = dict(store=dist.HashStore(), world_size=1, rank=0)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    dist.init_process_group(backend, **kwargs)
    return dev


def make_mesh(n_id: int = 1) -> Mesh:
    """The (mc, id) mesh over the initialised group: n_mc = world / n_id.
    Every rank creates every subgroup, in the same order (new_group is
    collective over the whole group)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_id < 1 or world % n_id:
        raise ValueError(f"{world} ranks are not divisible by --mesh-id "
                         f"{n_id}")
    n_mc = world // n_id
    mc, id_ = rank_coords(rank, n_id)
    mc_groups = [dist.new_group([m * n_id + i for m in range(n_mc)])
                 for i in range(n_id)]
    id_groups = [dist.new_group([m * n_id + i for i in range(n_id)])
                 for m in range(n_mc)]
    return Mesh(n_mc, n_id, mc, id_, mc_groups[id_], id_groups[mc])
