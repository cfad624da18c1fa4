"""Sharded identity gallery: the exact global nearest identity over a
gallery whose rows are split over the ``id`` ranks (port of
certifyingfacerecognition_tpu/parallel/gallery.py).

Each id rank holds a contiguous block of rows (blocks may differ by one
row; the block's global offset is kept), finds the exact-refined nearest
row of its block, and one all-gather of the per-rank (distance, global
index) winners over ``id_group`` resolves the global argmin. Exact ties
go to the lowest rank, which holds the lowest global index, as a
single-device argmin over the whole gallery gives.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from ..ops import distances as D
from ..ops import geometry as G
from ..utils.profiling import span


def shard_rows(n: int, n_id: int, id_: int) -> Tuple[int, int]:
    """[start, stop) of rank ``id_``'s block of an n-row gallery: the
    first n % n_id blocks have one row more (np.array_split's split)."""
    if n < n_id:
        raise ValueError(f"a gallery of {n} rows cannot be split over "
                         f"{n_id} id ranks")
    size, extra = divmod(n, n_id)
    start = id_ * size + min(id_, extra)
    return start, start + size + (id_ < extra)


def merge_shard_winners(dists: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """Global winners [B] from the per-shard winners' distances and global
    indices, both [n_id, B]: the smallest distance, and on an exact tie
    the lowest shard (torch.argmin returns the first minimum)."""
    win = torch.argmin(dists, dim=0)
    return idx.gather(0, win[None, :])[0]


def sharded_nearest(x: torch.Tensor, gallery_shard: torch.Tensor,
                    offset: int, id_group, method: str = "insightface",
                    k: int = 8) -> torch.Tensor:
    """Global nearest identities [B] of embeddings x [B, 512]; this rank
    holds gallery rows [offset, offset + len(gallery_shard)). Collective
    over ``id_group``."""
    d, local = D.nearest_refined(x, gallery_shard, method, k)
    gidx = local + offset
    n_id = dist.get_world_size(id_group)
    all_d = [torch.empty_like(d) for _ in range(n_id)]
    all_i = [torch.empty_like(gidx) for _ in range(n_id)]
    dist.all_gather(all_d, d, group=id_group)
    dist.all_gather(all_i, gidx, group=id_group)
    return merge_shard_winners(torch.stack(all_d), torch.stack(all_i))


def make_sharded_gallery_predict_fn(embed_fn: Callable, id_group,
                                    offset: int,
                                    method: str = "insightface"
                                    ) -> Callable:
    """predict_fn(params, z [512], p [B, k]) -> global identities [B], with
    params = {gen, frm, dirs [k, 512], gallery: this rank's shard}."""

    def fn(params, z, p):
        with torch.inference_mode():
            w = z[None, :] + G.matmul_f32(p, params["dirs"])
            embs = embed_fn(params["gen"], params["frm"], w).float()
            with span("gallery_head"):
                return sharded_nearest(embs, params["gallery"], offset,
                                       id_group, method)

    return fn
