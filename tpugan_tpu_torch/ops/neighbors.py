"""Neighbour search, sampling and grouping on padded point batches
(``tpugan_tpu/ops/neighbors.py``).

Distances are ``max(|q|^2 + |c|^2 - 2 q.c, 0)`` in f32, the formula of the
JAX package. ``knn(..., approx=True)`` is the JAX ``approx`` flag: at the
shapes where the TPU kernel runs its bf16 body (``kernels.knn.takes_approx``
and at most 24,576 candidates) it takes the approximate kernel, which ranks
bf16 distances and may miss a tail neighbour; elsewhere it is exact.
``graph_knn`` passes ``APPROX_GRAPH_KNN``, which is False here (the JAX
package's default is True, so its TPU serving graphs were approximate): the
port's graphs are exact unless a caller turns the switch on, as
``eval_fluid --approx_graph`` does. Invalid candidates carry a 1e10 bias and
are never selected while enough valid ones exist.

kNN distances are differentiable (:class:`_Knn`: the gather and
scatter-add formula of the JAX kNN kernel's VJP); FPS and ball-query
indices carry no gradient, and gradients reach the points through
:func:`gather` / :func:`group`.

Point-sharded serving (``point_shard_axis``, ``tpugan_tpu/ops/neighbors.py``):
inside the context every point and feature tensor is this rank's
contiguous N-shard of one cloud. ``graph_knn`` then all-gathers the
candidate side (and its valid mask) and returns GLOBAL indices, so each
rank finds the exact neighbours of its rows in the whole cloud, and
``gather`` all-gathers the table before indexing. Everything between graph
builds and gathers in the generator is pointwise, so the model runs
unmodified. Outside the context neither makes a collective.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from tpugan_tpu_torch.ops.kernels.ball_query import ball_query_kernel
from tpugan_tpu_torch.ops.kernels.fps import fps_kernel
from tpugan_tpu_torch.ops.kernels.knn import (PALLAS_MAX_NC,
                                               knn_approx_kernel, knn_kernel,
                                               sqdist, takes_approx)

BIG = 1e10
_CHUNK = 2048   # query rows per [rows, Nc] block (radius_count, the
                # auction's bids, the MMD)

# Graph kNN (EdgeConv / IDGCN graph builds) through the approximate bf16
# kernel where it applies; metrics, losses, ball queries and interpolation
# stay exact. Read at call time.
APPROX_GRAPH_KNN = False


def set_approx_graph_knn(enabled: bool) -> None:
    global APPROX_GRAPH_KNN
    APPROX_GRAPH_KNN = bool(enabled)


# The group the point axis is sharded over (None: not sharded). Set by
# ``point_shard_axis`` around a sharded serving step; read by ``graph_knn``
# and ``gather`` at call time.
_POINT_SHARD_AXIS = None


@contextlib.contextmanager
def point_shard_axis(group):
    """Declare the process group (``parallel.mesh.DATA_AXIS`` for the
    default one) the point axis is sharded over, restored on exit."""
    global _POINT_SHARD_AXIS
    prev, _POINT_SHARD_AXIS = _POINT_SHARD_AXIS, group
    try:
        yield
    finally:
        _POINT_SHARD_AXIS = prev


def _gather_points(x: torch.Tensor) -> torch.Tensor:
    """Every rank's shard of ``x`` [B, N/w, ...] concatenated along N."""
    from tpugan_tpu_torch.parallel.mesh import all_gather

    return all_gather(x, 1, _POINT_SHARD_AXIS)


# [..., Nq, D] x [..., Nc, D] -> [..., Nq, Nc] squared distances
pairwise_sqdist = sqdist


def valid_bias(c_valid: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """Additive candidate bias: 0 where valid, BIG where not."""
    if c_valid is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.where(c_valid, 0.0, BIG).to(torch.float32)


def knn(query: torch.Tensor, cand: Optional[torch.Tensor] = None, k: int = 16,
        c_valid: Optional[torch.Tensor] = None, approx: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbours, ascending, ties to the lower index.

    query [B, Nq, D], cand [B, Nc, D] (default: query, so self is found at
    distance 0), c_valid [B, Nc] bool. Returns (d2 [B, Nq, k] f32,
    idx [B, Nq, k] int64). When k > Nc the tail is padded with BIG
    distances repeating the last index. bf16 inputs are searched in f32.
    ``approx``: the approximate bf16 kernel where the TPU kernel would run
    it (module note; graph builds only), else exact.
    """
    if cand is None:
        cand = query
    query, cand = query.float(), cand.float()
    nc = cand.shape[-2]
    k_eff = min(k, nc)
    bias = valid_bias(c_valid, cand.shape[:-1], cand.device)
    approx = approx and k_eff == k and nc <= PALLAS_MAX_NC and takes_approx(nc, k)
    d2, idx = _Knn.apply(query, cand, bias, k_eff, approx)
    if k_eff < k:
        pad = k - k_eff
        d2 = torch.cat([d2, d2.new_full(d2.shape[:-1] + (pad,), BIG)], -1)
        idx = torch.cat([idx, idx[..., -1:].expand(idx.shape[:-1] + (pad,))],
                        -1)
    return d2, idx


def scatter_sqdist_grad(query, cand, idx, g_d2):
    """(d/dquery, d/dcand) of ``d2[b, q, j] = |query[b, q] - cand[b,
    idx[b, q, j]]|^2`` against the cotangent ``g_d2`` [B, Nq, k]: the
    gather and scatter-add formula of ``knn_kernel.py : _knn_bwd``."""
    b, nq, k = idx.shape
    d = cand.shape[-1]
    flat = idx.reshape(b, nq * k)
    diff = query[:, :, None, :] - gather(cand, flat).reshape(b, nq, k, d)
    gq = (2.0 * g_d2[..., None] * diff).sum(2)
    gc = torch.zeros_like(cand).scatter_add_(
        1, flat[..., None].expand(-1, -1, d),
        (-2.0 * g_d2[..., None] * diff).reshape(b, nq * k, d))
    return gq, gc


class _Knn(torch.autograd.Function):
    """A kNN kernel (exact, or approximate with ``approx``) with a
    differentiable distance output (the indices carry no gradient; the
    backward is the JAX VJP both modes share)."""

    @staticmethod
    def forward(ctx, query, cand, bias, k, approx):
        search = knn_approx_kernel if approx else knn_kernel
        d2, idx = search(query, cand, bias, k)
        ctx.save_for_backward(query, cand, idx)
        ctx.mark_non_differentiable(idx)
        return d2, idx

    @staticmethod
    def backward(ctx, g_d2, _):
        query, cand, idx = ctx.saved_tensors
        gq, gc = scatter_sqdist_grad(query, cand, idx, g_d2)
        return gq, gc, None, None, None


def radius_mask_knn(query: torch.Tensor, cand: Optional[torch.Tensor] = None,
                    k: int = 16, radius: float = 0.1,
                    c_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN restricted to a radius: (d2, idx, in_range) with in_range True
    where neighbour j lies within ``radius`` (out-of-range slots keep the
    global kNN index and distance)."""
    d2, idx = knn(query, cand, k, c_valid=c_valid)
    return d2, idx, d2 < float(np.float32(radius) ** 2)


def dilated_knn_graph(x: torch.Tensor, k: int = 9, dilation: int = 1,
                      c_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k // dilation neighbour indices by dilated kNN (reference
    ``DilatedKnnGraph`` / ``Dilated``, gcn_lib/pointnet/gcn.py:48-93): every
    ``dilation``-th of the k nearest, [B, N, k // dilation]."""
    return knn(x, k=k, c_valid=c_valid)[1][:, :, ::dilation]


def knn_graph(x: torch.Tensor, k: int = 9,
              c_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain kNN edge list (reference ``KNNGraph``,
    gcn_lib/graph_utils.py:65-87) as [B, N, k] indices."""
    return knn(x, k=k, c_valid=c_valid)[1]


def fixed_radius_graph(x: torch.Tensor, radius: float, k: int = 32,
                       c_valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The radius-bounded neighbour list (reference ``FixedRadiusGraph``,
    gcn_lib/graph_utils.py:39-62): [B, N, k] indices and the in-range mask;
    ``torch.where(mask, idx, -1)`` gives the reference's -1 padding."""
    _, idx, in_range = radius_mask_knn(x, x, k=k, radius=radius,
                                       c_valid=c_valid)
    return idx, in_range


def fps(pos: torch.Tensor, npoint: int, valid: Optional[torch.Tensor] = None,
        start_idx: int = 0, start: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """Iterative farthest point sampling: idx [B, npoint] int64.

    Starts from ``start`` [B] (default ``start_idx`` in every row). With
    ``valid`` [B, N] bool, invalid points are never picked while a valid
    one remains, and an invalid start moves to the row's first valid point.
    Indices carry no gradient.
    """
    b, n, _ = pos.shape
    pos = pos.detach().float()
    if start is None:
        start = torch.full((b,), start_idx, dtype=torch.int64, device=pos.device)
    start = start.to(device=pos.device, dtype=torch.int64)
    if valid is None:
        penalty = torch.zeros((b, n), dtype=torch.float32, device=pos.device)
    else:
        penalty = torch.where(valid, 0.0, -BIG).to(torch.float32)
        first_valid = torch.argmax(valid.to(torch.uint8), dim=-1)
        start_ok = torch.gather(valid, 1, start[:, None])[:, 0]
        start = torch.where(start_ok, start, first_valid)
    return fps_kernel(pos, npoint, penalty, start)


def ball_query(query: torch.Tensor, cand: torch.Tensor, radius: float,
               nsample: int, c_valid: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """pointnet2 ball query: the first ``nsample`` candidates in index order
    within ``radius``; slots with no hit repeat the first hit (0 when the
    ball is empty). Returns idx [B, Nq, nsample] int64, no gradient."""
    bias = (torch.zeros(cand.shape[:2], dtype=torch.float32, device=cand.device)
            if c_valid is None else torch.where(c_valid, 0.0, 2.0).to(torch.float32))
    return ball_query_kernel(query.detach().float(), cand.detach().float(),
                             radius, nsample, bias)


def graph_knn(x: torch.Tensor, k: int,
              c_valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN graph of a point or feature cloud over itself; approximate where
    ``APPROX_GRAPH_KNN`` is on and the shape takes the approximate kernel.
    Under ``point_shard_axis``: this rank's rows against the gathered cloud,
    global indices."""
    if _POINT_SHARD_AXIS is not None:
        cv = _gather_points(c_valid) if c_valid is not None else None
        return knn(x, _gather_points(x), k=k, c_valid=cv,
                   approx=APPROX_GRAPH_KNN)
    return knn(x, k=k, c_valid=c_valid, approx=APPROX_GRAPH_KNN)


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M] -> [B, M, C]. Under
    ``point_shard_axis`` ``points`` is this rank's shard and ``idx`` global:
    the table is gathered first."""
    if _POINT_SHARD_AXIS is not None:
        points = _gather_points(points)
    return torch.gather(points, 1,
                        idx[..., None].expand(-1, -1, points.shape[-1]))


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M, K] -> [B, M, K, C]."""
    b, m, k = idx.shape
    return gather(points, idx.reshape(b, m * k)).reshape(
        b, m, k, points.shape[-1])


def query_and_group(xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: Optional[torch.Tensor], radius: float,
                    nsample: int, use_xyz: bool = True,
                    c_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ball query + grouping + recentred coordinates: [B, M, nsample, 3 + C]
    (``[..., C]`` without xyz, ``[..., 3]`` without features)."""
    idx = ball_query(new_xyz, xyz, radius, nsample, c_valid=c_valid)
    grouped_xyz = group(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        if not use_xyz:
            raise ValueError("query_and_group needs features or xyz")
        return grouped_xyz
    grouped_feat = group(features, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feat], dim=-1)
    return grouped_feat


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor],
              use_xyz: bool = True) -> torch.Tensor:
    """One group holding every point: [B, 1, N, 3 + C]."""
    if features is None:
        return xyz[:, None]
    if use_xyz:
        return torch.cat([xyz[:, None], features[:, None]], dim=-1)
    return features[:, None]


def radius_count(query: torch.Tensor, cand: torch.Tensor, radius: float,
                 cap: Optional[int] = None,
                 c_valid: Optional[torch.Tensor] = None,
                 include_self: bool = True) -> torch.Tensor:
    """Candidates within ``radius`` of each query, [B, Nq] int64, saturating
    at ``cap``. Plain PyTorch (the JAX package has no kernel for it), in
    query chunks of [rows, Nc] distances."""
    r2 = float(np.float32(radius) ** 2)
    query, cand = query.detach().float(), cand.detach().float()
    outs = []
    for s in range(0, query.shape[1], _CHUNK):
        d2 = sqdist(query[:, s:s + _CHUNK], cand)
        within = d2 < r2
        if not include_self:
            within &= d2 > 1e-12
        if c_valid is not None:
            within &= c_valid[:, None, :]
        cnt = within.sum(-1)
        outs.append(cnt if cap is None else torch.clamp_max(cnt, cap))
    return torch.cat(outs, 1)
