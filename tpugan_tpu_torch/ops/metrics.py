"""Nearest neighbour, Chamfer distance and the masking-loss target on padded
point batches (the Chamfer and masking part of ``tpugan_tpu/ops/metrics.py``).

The nearest-neighbour distance is differentiable (:class:`_Nn1`), with the
gather and scatter-add formula the JAX kNN kernel's VJP uses for k = 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpugan_tpu_torch.ops.kernels.nn1 import nn1_kernel
from tpugan_tpu_torch.ops.neighbors import (radius_count, scatter_sqdist_grad,
                                            valid_bias)


class _Nn1(torch.autograd.Function):
    """The nn1 kernel with a differentiable distance output."""

    @staticmethod
    def forward(ctx, query, cand, bias):
        d2, idx = nn1_kernel(query, cand, bias)
        ctx.save_for_backward(query, cand, idx)
        ctx.mark_non_differentiable(idx)
        return d2, idx

    @staticmethod
    def backward(ctx, g_d2, _):
        query, cand, idx = ctx.saved_tensors
        gq, gc = scatter_sqdist_grad(query, cand, idx[..., None],
                                     g_d2[..., None])
        return gq, gc, None


def nearest_neighbor(query: torch.Tensor, cand: torch.Tensor,
                     c_valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbour of each query point: (d2 [B, Nq] f32,
    idx [B, Nq] int64). On the card this is the nn1 kernel at every size
    (it streams candidates, so it has no candidate cap)."""
    query, cand = query.float(), cand.float()
    return _Nn1.apply(query, cand,
                      valid_bias(c_valid, cand.shape[:-1], cand.device))


def chamfer(a: torch.Tensor, b: torch.Tensor,
            a_valid: Optional[torch.Tensor] = None,
            b_valid: Optional[torch.Tensor] = None,
            bidirectional: bool = True) -> torch.Tensor:
    """Masked Chamfer distance, per cloud: the sum of squared
    nearest-neighbour distances a -> b, plus b -> a when bidirectional.
    Invalid points count 0 as queries and are never selected as
    neighbours. Returns [B]."""
    d2_ab, _ = nearest_neighbor(a, b, c_valid=b_valid)
    if a_valid is not None:
        d2_ab = torch.where(a_valid, d2_ab, 0.0)
    out = d2_ab.sum(-1)
    if bidirectional:
        d2_ba, _ = nearest_neighbor(b, a, c_valid=a_valid)
        if b_valid is not None:
            d2_ba = torch.where(b_valid, d2_ba, 0.0)
        out = out + d2_ba.sum(-1)
    return out


def masking_target(pos_gt: torch.Tensor, pos_input: torch.Tensor,
                   particle_radius: float,
                   gt_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Target of the keep-probability head, [B, N_input] in {0, 1}: a
    ground-truth point is dense with more than 3 neighbours within
    1.4 * radius (capped at 16); an input point takes the density bit of
    its nearest ground-truth point within 1.9 * radius, else 0."""
    cnt = radius_count(pos_gt, pos_gt, 1.4 * particle_radius, cap=16,
                       c_valid=gt_valid)
    dense = (cnt > 3).float()
    with torch.no_grad():
        d2, idx = nearest_neighbor(pos_input, pos_gt, c_valid=gt_valid)
    in_range = d2 < (1.9 * particle_radius) ** 2
    return torch.where(in_range, torch.gather(dense, 1, idx), 0.0)
