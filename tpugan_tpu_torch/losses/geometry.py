"""Geometric losses on masked point batches (the train step's part of
``tpugan_tpu/losses/geometry.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpugan_tpu_torch.ops.metrics import chamfer, masking_target


def chamfer_distance_loss(a: torch.Tensor, b: torch.Tensor,
                          a_valid: Optional[torch.Tensor] = None,
                          b_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Bidirectional summed Chamfer distance, batch-mean scalar."""
    return chamfer(a, b, a_valid, b_valid, bidirectional=True).mean()


def masking_loss(pos_gt: torch.Tensor, pos_input: torch.Tensor,
                 binary_mask: torch.Tensor, particle_radius: float,
                 gt_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 between the keep-probabilities and the density-derived target."""
    target = masking_target(pos_gt, pos_input, particle_radius, gt_valid)
    return (binary_mask - target).abs().mean()


def tpugan_sr_loss(w1: float, gt_pos: torch.Tensor, pred_pos: torch.Tensor,
                   input_pos: Optional[torch.Tensor],
                   mask: Optional[torch.Tensor], particle_radius: float,
                   n_iter: int, pred_valid: Optional[torch.Tensor] = None,
                   gt_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Chamfer + w1 * masking loss, Chamfer, masking loss). For the first
    10 iterations (or when w1 == 0) the masking loss is pinned at 1.0, the
    value that also keeps the train step's adversarial gate shut."""
    cd = chamfer(gt_pos, pred_pos, gt_valid, pred_valid).mean()
    if w1 != 0 and mask is not None and n_iter > 10:
        ml = masking_loss(gt_pos, input_pos, mask, particle_radius, gt_valid)
    else:
        ml = torch.ones((), device=cd.device)
    return cd + w1 * ml, cd, ml
