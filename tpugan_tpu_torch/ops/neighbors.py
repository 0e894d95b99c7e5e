"""Neighbour search, sampling and grouping on padded point batches
(``tpugan_tpu/ops/neighbors.py``).

Distances are ``max(|q|^2 + |c|^2 - 2 q.c, 0)`` in f32, the formula of the
JAX package. The port is exact everywhere: the JAX ``approx`` flag selects a
bf16 TPU kernel and is a no-op off the TPU, so it has no counterpart here.
Invalid candidates carry a 1e10 bias and are never selected while enough
valid ones exist.

kNN distances are differentiable (:class:`_Knn`: the gather and
scatter-add formula of the JAX kNN kernel's VJP); FPS and ball-query
indices carry no gradient, and gradients reach the points through
:func:`gather` / :func:`group`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpugan_tpu_torch.ops.kernels.ball_query import ball_query_kernel
from tpugan_tpu_torch.ops.kernels.fps import fps_kernel
from tpugan_tpu_torch.ops.kernels.knn import knn_kernel, sqdist

BIG = 1e10
_CHUNK = 2048   # query rows per [rows, Nc] block of radius_count


# [..., Nq, D] x [..., Nc, D] -> [..., Nq, Nc] squared distances
pairwise_sqdist = sqdist


def valid_bias(c_valid: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """Additive candidate bias: 0 where valid, BIG where not."""
    if c_valid is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.where(c_valid, 0.0, BIG).to(torch.float32)


def knn(query: torch.Tensor, cand: Optional[torch.Tensor] = None, k: int = 16,
        c_valid: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbours, ascending, ties to the lower index.

    query [B, Nq, D], cand [B, Nc, D] (default: query, so self is found at
    distance 0), c_valid [B, Nc] bool. Returns (d2 [B, Nq, k] f32,
    idx [B, Nq, k] int64). When k > Nc the tail is padded with BIG
    distances repeating the last index. bf16 inputs are searched in f32.
    """
    if cand is None:
        cand = query
    query, cand = query.float(), cand.float()
    nc = cand.shape[-2]
    k_eff = min(k, nc)
    bias = valid_bias(c_valid, cand.shape[:-1], cand.device)
    d2, idx = _Knn.apply(query, cand, bias, k_eff)
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
    """The kNN kernel with a differentiable distance output (the indices
    carry no gradient)."""

    @staticmethod
    def forward(ctx, query, cand, bias, k):
        d2, idx = knn_kernel(query, cand, bias, k)
        ctx.save_for_backward(query, cand, idx)
        ctx.mark_non_differentiable(idx)
        return d2, idx

    @staticmethod
    def backward(ctx, g_d2, _):
        query, cand, idx = ctx.saved_tensors
        gq, gc = scatter_sqdist_grad(query, cand, idx, g_d2)
        return gq, gc, None, None


def radius_mask_knn(query: torch.Tensor, cand: Optional[torch.Tensor] = None,
                    k: int = 16, radius: float = 0.1,
                    c_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN restricted to a radius: (d2, idx, in_range) with in_range True
    where neighbour j lies within ``radius`` (out-of-range slots keep the
    global kNN index and distance)."""
    d2, idx = knn(query, cand, k, c_valid=c_valid)
    return d2, idx, d2 < float(np.float32(radius) ** 2)


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
    """kNN graph of a point or feature cloud over itself."""
    return knn(x, k=k, c_valid=c_valid)


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, M] -> [B, M, C]."""
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
