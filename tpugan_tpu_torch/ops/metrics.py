"""Nearest neighbour and Chamfer distance on padded point batches (the
Chamfer part of ``tpugan_tpu/ops/metrics.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpugan_tpu_torch.ops.kernels.nn1 import nn1_kernel
from tpugan_tpu_torch.ops.neighbors import valid_bias


def nearest_neighbor(query: torch.Tensor, cand: torch.Tensor,
                     c_valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbour of each query point: (d2 [B, Nq] f32,
    idx [B, Nq] int64). On the card this is the nn1 kernel at every size
    (it streams candidates, so it has no candidate cap)."""
    query, cand = query.float(), cand.float()
    return nn1_kernel(query, cand,
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
