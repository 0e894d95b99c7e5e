"""SPH-kernel-weighted scattered interpolation (the dense form of
``tpugan_tpu/ops/interpolate.py``).

``cubic_interpolation_dense`` sums over every candidate within the cutoff
through the interp kernel (``ops/kernels/interp.py``) in one launch at any
candidate count. The SPH weights (bicubic, spline1, linear, exponential)
are ``ops/kernels/interp.py : sph_weight``. The capped
``cubic_interpolation`` and the binned kernel are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpugan_tpu_torch.ops.kernels.interp import interp_kernel


def cubic_interpolation_dense(query_pos: torch.Tensor, field: torch.Tensor,
                              pos: torch.Tensor, cutoff: float,
                              pos_valid: Optional[torch.Tensor] = None,
                              kind: str = "bicubic") -> torch.Tensor:
    """out[q] = sum_n w(|q - p_n|) field[n] / (sum_n w + 1e-6) over every
    candidate n within ``cutoff`` (no K cap). query_pos [B, Nq, 3] (or
    [Nq, 3]), field [B, Nc, C], pos [B, Nc, 3]. Forward only."""
    squeeze = query_pos.dim() == 2
    if squeeze:
        query_pos, field, pos = query_pos[None], field[None], pos[None]
        if pos_valid is not None:
            pos_valid = pos_valid[None]
    bias = (torch.zeros(pos.shape[:2], dtype=torch.float32, device=pos.device)
            if pos_valid is None
            else torch.where(pos_valid, 0.0, 1e10).to(torch.float32))
    with torch.no_grad():
        out, _ = interp_kernel(query_pos.float(), pos.float(), field.float(),
                               cutoff, bias, kind=kind)
    return out[0] if squeeze else out
