"""SPH-kernel-weighted scattered interpolation (``tpugan_tpu/ops/interpolate.py``).

``cubic_interpolation`` is the capped form: the k nearest in-cutoff
neighbours of each query (radius kNN, k = 32 by default), with the cubic
B-spline weight of the distance. ``cubic_interpolation_dense`` sums over
every candidate within the cutoff, in one launch at any candidate count:
the dense interp kernel (``ops/kernels/interp.py``) by default, the
cell-grid kernel (``ops/kernels/binned_interp.py``) with ``binned=True``.
The dense forms' SPH weights (bicubic, spline1, linear, exponential) are
``ops/kernels/interp.py : sph_weight``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpugan_tpu_torch.ops.kernels.binned_interp import binned_interp
from tpugan_tpu_torch.ops.kernels.interp import interp_kernel
from tpugan_tpu_torch.ops.neighbors import group, radius_mask_knn


def spline(q: torch.Tensor) -> torch.Tensor:
    """The cubic B-spline of q = r / cutoff with coefficient 1:
    6 (q^3 - q^2) + 1 on [0, 1/2], 2 (1 - q)^3 on (1/2, 1], 0 beyond."""
    return torch.where(q <= 0.5, 6.0 * (q ** 3 - q ** 2) + 1.0,
                       torch.where(q <= 1.0, 2.0 * (1.0 - q) ** 3, 0.0))


def exponential_kernel(r: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Gaussian SPH weight of a distance (reference
    gcn_lib/interpolation.py:83-85): pi^(-3/2) cutoff^3 exp(-(r / cutoff)^2),
    the reference's coefficient as written."""
    coeff = 1.0 / math.sqrt(math.pi ** 3) * cutoff ** 3
    return coeff * torch.exp(-((r / cutoff) ** 2))


def linear_kernel(r: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Tent weight max(1 - r / cutoff, 0) (reference
    gcn_lib/interpolation.py:88-89)."""
    return torch.clamp_min(1.0 - r / cutoff, 0.0)


def bicubic_kernel(r: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Cubic B-spline SPH kernel of a distance, scaled by 8 / (pi cutoff^3)."""
    q = r / cutoff
    return torch.where(q >= 0.0, spline(q), 0.0) * (8.0 / (math.pi * cutoff ** 3))


def cubic_interpolation(query_pos: torch.Tensor, field: torch.Tensor,
                        pos: torch.Tensor, cutoff: float, k: int = 32,
                        pos_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """out[q] = sum_n w_qn field[n] / (sum_n w_qn + 1e-6) over the (up to)
    k nearest in-cutoff neighbours n of q, w the bicubic kernel of the
    distance; a query with no neighbour in range gets 0. query_pos [B, Nq, 3]
    (or [Nq, 3]), field [B, Nc, C], pos [B, Nc, 3], all batched or all not."""
    if not query_pos.dim() == field.dim() == pos.dim():
        raise ValueError(
            "cubic_interpolation: query_pos, field and pos must all be "
            "batched [B, N, .] or all unbatched [N, .]; got dims "
            f"{query_pos.dim()}/{field.dim()}/{pos.dim()}")
    squeeze = query_pos.dim() == 2
    if squeeze:
        query_pos, field, pos = query_pos[None], field[None], pos[None]
        if pos_valid is not None:
            pos_valid = pos_valid[None]
    d2, idx, in_range = radius_mask_knn(query_pos, pos, k=k, radius=cutoff,
                                        c_valid=pos_valid)
    r = torch.sqrt(torch.clamp_min(d2, 0.0))
    w = torch.where(in_range, bicubic_kernel(r, cutoff), 0.0)    # [B, Nq, k]
    num = torch.einsum("bqk,bqkc->bqc", w, group(field, idx))
    out = num / (w.sum(-1, keepdim=True) + 1e-6)
    return out[0] if squeeze else out


def cubic_interpolation_dense(query_pos: torch.Tensor, field: torch.Tensor,
                              pos: torch.Tensor, cutoff: float,
                              pos_valid: Optional[torch.Tensor] = None,
                              kind: str = "bicubic",
                              binned: bool = False) -> torch.Tensor:
    """out[q] = sum_n w(|q - p_n|) field[n] / (sum_n w + 1e-6) over every
    candidate n within ``cutoff`` (no K cap). query_pos [B, Nq, 3] (or
    [Nq, 3]), field [B, Nc, C], pos [B, Nc, 3]. Forward only.

    ``binned`` takes the cell-grid kernel (the same sum over the candidates
    of the 27 cells around each query) in place of the dense kernel. The
    JAX package's default reads ``TPUGAN_BINNED_INTERP``, which is off
    unless set; the port reads no environment variable.
    """
    squeeze = query_pos.dim() == 2
    if squeeze:
        query_pos, field, pos = query_pos[None], field[None], pos[None]
        if pos_valid is not None:
            pos_valid = pos_valid[None]
    bias = (torch.zeros(pos.shape[:2], dtype=torch.float32, device=pos.device)
            if pos_valid is None
            else torch.where(pos_valid, 0.0, 1e10).to(torch.float32))
    run = binned_interp if binned else interp_kernel
    with torch.no_grad():
        out, _ = run(query_pos.float(), pos.float(), field.float(), cutoff,
                     bias, kind=kind)
    return out[0] if squeeze else out
