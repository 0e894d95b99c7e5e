"""Point-axis (N-axis) sharded neighbour ops
(``tpugan_tpu/parallel/sharded_ops.py``).

Each rank holds a contiguous N-shard of the query and of the candidate
cloud; the candidate side is all-gathered, and the rank runs the exact
kernel on its query rows against the whole candidate cloud. Returned
indices are global (they index the gathered cloud), and a rank's rows
equal those rows of the unsharded op, up to the order of the distance
sums inside the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpugan_tpu_torch.ops.metrics import nearest_neighbor
from tpugan_tpu_torch.ops.neighbors import ball_query, knn
from tpugan_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce_, gather_cat


def sharded_knn(query: torch.Tensor, cand: torch.Tensor, k: int,
                group=DATA_AXIS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of this rank's query rows [B, Nq/w, D] against the
    gathered candidates (this rank's [B, Nc/w, D]): (d2, global idx)."""
    return knn(query, gather_cat(cand, 1, group), k)


def sharded_ball_query(query: torch.Tensor, cand: torch.Tensor, radius: float,
                       nsample: int, group=DATA_AXIS) -> torch.Tensor:
    """pointnet2 ball query of this rank's query rows against the gathered
    candidates: [B, Nq/w, nsample] global indices."""
    return ball_query(query, gather_cat(cand, 1, group), radius, nsample)


def sharded_chamfer(a: torch.Tensor, b: torch.Tensor,
                    group=DATA_AXIS) -> torch.Tensor:
    """Bidirectional summed Chamfer distance [B] of two N-sharded clouds:
    each rank sums its rows' nearest distances in both directions against
    the gathered other cloud, and the partial sums meet in an all-reduce.
    Every rank returns the total."""
    d_ab, _ = nearest_neighbor(a, gather_cat(b, 1, group))
    d_ba, _ = nearest_neighbor(b, gather_cat(a, 1, group))
    return all_reduce_(d_ab.sum(-1) + d_ba.sum(-1), group)
