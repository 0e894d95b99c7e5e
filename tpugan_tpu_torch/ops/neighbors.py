"""Neighbour search and grouping on padded point batches (serving subset of
``tpugan_tpu/ops/neighbors.py``).

Distances are ``max(|q|^2 + |c|^2 - 2 q.c, 0)`` in f32, the formula of the
JAX package. The port is exact everywhere: the JAX ``approx`` flag selects a
bf16 TPU kernel and is a no-op off the TPU, so it has no counterpart here.
Invalid candidates carry a 1e10 bias and are never selected while enough
valid ones exist.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpugan_tpu_torch.ops.kernels.knn import knn_kernel, sqdist

BIG = 1e10


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
    d2, idx = knn_kernel(query, cand, bias, k_eff)
    if k_eff < k:
        pad = k - k_eff
        d2 = torch.cat([d2, d2.new_full(d2.shape[:-1] + (pad,), BIG)], -1)
        idx = torch.cat([idx, idx[..., -1:].expand(idx.shape[:-1] + (pad,))],
                        -1)
    return d2, idx


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
