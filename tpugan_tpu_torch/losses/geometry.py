"""Geometric losses on masked point batches (``tpugan_tpu/losses/geometry.py``).

All losses take optional validity masks, so they run on the hard-masked
(999-sentinel) padded clouds the generator emits. On the card the
radius-bounded ones search with the kNN kernel (``radius_mask_knn``), the
Chamfer ones with nn1 (``chamfer``) and the EMD with the port's auction;
their gradients reach the coordinates through the kNN distances' and
nn1's autograd functions and the matched targets' gather.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpugan_tpu_torch.ops.metrics import (auction_assignment, chamfer,
                                          masking_target)
from tpugan_tpu_torch.ops.neighbors import radius_mask_knn


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


def _self_neighbor_sq_distances(pos: torch.Tensor, k: int, radius: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2, ok): the k nearest self-neighbours' squared distances and
    whether each is within ``radius`` and not the point itself or a
    coincident one (the reference's ``distance < 1e-9`` masks)."""
    d2, _, in_range = radius_mask_knn(pos, pos, k=k, radius=radius)
    return d2, in_range & (d2 > 1e-9)


def _distances(d2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(d2, 1e-20))


def repulsion_loss(pred_pos: torch.Tensor, h: float,
                   furthest_distance: float = 1.0) -> torch.Tensor:
    """Penalise clumping: (min(d, 3.1h) - h)^2 / h^2 summed over at most 8
    neighbours within 1.1h, batch mean (reference loss.py:139-155)."""
    h = h / furthest_distance
    if pred_pos.dim() == 2:
        pred_pos = pred_pos[None]
    d2, ok = _self_neighbor_sq_distances(pred_pos, k=8, radius=1.1 * h)
    smeared = (torch.clamp_max(_distances(d2), 3.1 * h) - h) ** 2 / (h * h)
    return torch.where(ok, smeared, 0.0).sum(-1).mean()


def density_loss(pred_pos: torch.Tensor, particle_radius: float
                 ) -> torch.Tensor:
    """Penalise spacing off the particle radius over at most 8 neighbours
    within 1.5 r (reference loss.py:228-243)."""
    if pred_pos.dim() == 2:
        pred_pos = pred_pos[None]
    d2, _, in_range = radius_mask_knn(pred_pos, pred_pos, k=8,
                                      radius=1.5 * particle_radius)
    ok = in_range & (d2 > 1e-8)   # the reference masks distance < 1e-4
    smeared = (_distances(d2) - particle_radius) ** 2 / particle_radius ** 2
    return torch.where(ok, smeared, 0.0).sum(-1).mean()


def density(pcd_pos: torch.Tensor, h: float, k: int = 32) -> torch.Tensor:
    """Per-particle density sum(relu(cutoff / d - 1)) over at most ``k``
    neighbours within cutoff = 2.1h (reference loss.py:100-118).
    pcd_pos [N, 3] -> [N, 1]."""
    cutoff = 2.1 * h
    d2, _, in_range = radius_mask_knn(pcd_pos[None], pcd_pos[None], k=k,
                                      radius=cutoff)
    ok = in_range & (d2 > 1e-8)
    contrib = torch.where(ok, torch.clamp_min(cutoff / _distances(d2) - 1.0,
                                              0.0), 0.0)
    return contrib.sum(-1)[0][:, None]


def refinement_loss(w: float, free_gt: torch.Tensor, pos_pred: torch.Tensor,
                    particle_radius: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(free_particle_loss + w density_loss, the two terms) (reference
    loss.py:246-250)."""
    free = free_particle_loss(free_gt, pos_pred, particle_radius)
    dns = density_loss(pos_pred, particle_radius)
    return free + w * dns, free, dns


def dense_loss(pred_prob: torch.Tensor, h: float,
               furthest_distance: float = 1.0) -> torch.Tensor:
    """Mean keep-probability mass over axis 1, scaled by 1/h (reference
    loss.py:131-136)."""
    h = h / furthest_distance
    return pred_prob.abs().sum(1).mean() / h


def edge_uniform_loss(edge: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Penalise offsets longer than 4 cutoff: the mean relative excess of
    the squared length over the offsets that exceed it, 0 when none does
    (reference loss.py:157-165)."""
    norm2 = (edge ** 2).sum(-1)
    target2 = (4.0 * cutoff + 1e-6) ** 2
    viol = norm2 > target2
    total = torch.where(viol, (norm2 - target2) / target2, 0.0).sum()
    count = viol.sum()
    return torch.where(count > 0, total / torch.clamp_min(count, 1), 0.0)


def temporal_loss(advect_right: torch.Tensor, advect_left: torch.Tensor,
                  upsample_right: torch.Tensor, upsample_left: torch.Tensor
                  ) -> torch.Tensor:
    """Mean Chamfer of the advected against the upsampled frames, over the
    two neighbour frames (reference loss.py:278-283)."""
    d1 = chamfer(advect_left, upsample_left).mean()
    d2 = chamfer(advect_right, upsample_right).mean()
    return 0.5 * d1 + 0.5 * d2


def free_particle_loss(free_gt: torch.Tensor, pos_pred: torch.Tensor,
                       particle_radius: float = 0.0,
                       free_valid: Optional[torch.Tensor] = None,
                       pred_valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Chamfer of the ground truth's free-surface particles against the
    prediction, batch mean (reference loss.py:217-225)."""
    return chamfer(free_gt, pos_pred, free_valid, pred_valid).mean()


def earth_mover_distance_loss(pred: torch.Tensor, target: torch.Tensor,
                              eps: float = 0.05, iters: int = 100
                              ) -> torch.Tensor:
    """Normalised auction-EMD loss (reference loss.py:294-316): the clouds
    are shifted by their joint minimum and scaled by the larger of their
    largest norms for the assignment (no gradient); the loss is the sum of
    the unscaled matched distances, [B] ([] for [N, 3] inputs), with
    gradients through the coordinates."""
    squeeze = pred.dim() == 2
    if squeeze:
        pred, target = pred[None], target[None]
    with torch.no_grad():
        m = torch.minimum(pred.amin(1, keepdim=True),
                          target.amin(1, keepdim=True))
        p, t = pred - m, target - m
        h = torch.maximum(p.norm(dim=-1).amax(1),
                          t.norm(dim=-1).amax(1))[:, None, None]
        assign = auction_assignment(p / h, t / h, eps=eps, iters=iters)
    matched = torch.gather(target, 1, assign[..., None].expand(-1, -1, 3))
    out = _distances(((pred - matched) ** 2).sum(-1)).sum(-1)
    return out[0] if squeeze else out
