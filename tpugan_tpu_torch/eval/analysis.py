"""Quantitative evaluation (``tpugan_tpu/eval/analysis.py``): normalised
Chamfer, auction EMD and Gaussian MMD against ground truth, upsample-advect
cycle consistency, SPH particle densities (exact and capped),
free-surface particle counts, and the action workload's clip metrics.

The metric functions take tensors and run where the tensors lie; the
density functions take numpy clouds and run on ``device`` (the CUDA card
when None, which raises without one).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from tpugan_tpu_torch import DT, resolve_device
from tpugan_tpu_torch.data.sampling import get_free_surface_particles
from tpugan_tpu_torch.ops.interpolate import cubic_interpolation, spline
from tpugan_tpu_torch.ops.kernels.binned_interp import binned_interp
from tpugan_tpu_torch.ops.metrics import (auction_assignment, chamfer,
                                          gaussian_mmd)
from tpugan_tpu_torch.ops.neighbors import radius_mask_knn


def _joint_normalize(a: torch.Tensor, b: torch.Tensor):
    """Shift both clouds by the elementwise minimum of their per-axis
    minima and scale both by the larger largest point norm: (a, b, h)."""
    m = torch.minimum(a.amin(1, keepdim=True), b.amin(1, keepdim=True))
    a, b = a - m, b - m
    h = torch.maximum(a.norm(dim=-1).amax(1),
                      b.norm(dim=-1).amax(1))[:, None, None]
    return a / h, b / h, h


def _assignment_emd(p: torch.Tensor, t: torch.Tensor, eps: float, iters: int,
                    phases: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean euclidean distance under the auction assignment, number of
    duplicate claims), both device scalars."""
    assign = auction_assignment(p, t, eps=eps, iters=iters, phases=phases)
    counts = torch.zeros_like(assign).scatter_add_(1, assign,
                                                   torch.ones_like(assign))
    n_dup = torch.clamp_min(counts - 1, 0).sum()
    matched = torch.gather(t, 1, assign[..., None].expand(-1, -1, 3))
    return (p - matched).norm(dim=-1).mean(), n_dup


def _warn_duplicates(n_dup: int, total: int, iters: int) -> None:
    if n_dup > 0:
        warnings.warn(
            f"auction EMD hit the {iters}-iteration cap with {n_dup} "
            f"duplicate assignments (of {total}); value is biased low",
            stacklevel=3)


def position_metrics(pos_pred: torch.Tensor, pos_gt: torch.Tensor,
                     emd_eps: float = 0.03, emd_iters: int = 2000,
                     pred_valid: Optional[torch.Tensor] = None,
                     gt_valid: Optional[torch.Tensor] = None,
                     emd_phases: int = 3) -> Tuple[float, float, float]:
    """(normalised Chamfer, mean EMD distance, MMD) between prediction and
    ground truth: the Chamfer over the full masked clouds divided by the
    ground truth's point count; the EMD on the jointly normalised clouds,
    both cut to the smaller valid count (valid points come first); the
    Gaussian MMD (blur 0.01) on the normalised valid points."""
    if pos_pred.dim() == 2:
        pos_pred, pos_gt = pos_pred[None], pos_gt[None]
        pred_valid = None if pred_valid is None else pred_valid[None]
        gt_valid = None if gt_valid is None else gt_valid[None]
    n_pred = (int(pred_valid.sum(-1).min()) if pred_valid is not None
              else pos_pred.shape[1])
    n_gt = (int(gt_valid.sum(-1).min()) if gt_valid is not None
            else pos_gt.shape[1])
    cd = chamfer(pos_pred, pos_gt, pred_valid, gt_valid).mean() / n_gt
    p, t, _ = _joint_normalize(pos_pred[:, :n_pred], pos_gt[:, :n_gt])
    n = min(n_pred, n_gt)
    emd, n_dup = _assignment_emd(p[:, :n], t[:, :n], emd_eps, emd_iters,
                                 phases=emd_phases)
    mmd = gaussian_mmd(p, t, blur=0.01).mean()
    _warn_duplicates(int(n_dup), p.shape[0] * n, emd_iters)
    return float(cd), float(emd), float(mmd)


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Centre on the centroid and scale by the largest point norm."""
    pc = pc - np.mean(pc, axis=0)
    return pc / np.max(np.sqrt(np.sum(pc ** 2, axis=1)))


def action_position_metrics(pos_pred: torch.Tensor, pos_gt: torch.Tensor,
                            emd_eps: float = 0.002, emd_iters: int = 3000,
                            emd_phases: int = 3) -> Tuple[float, float]:
    """The MSR-Action3D protocol (reference
    train_action/analysis_helper.py:60-68): (the bidirectional summed
    Chamfer over the fixed 2,048, the auction EMD of the clouds halved, at
    eps 0.002, doubled back)."""
    if pos_pred.dim() == 2:
        pos_pred, pos_gt = pos_pred[None], pos_gt[None]
    cd = chamfer(pos_pred, pos_gt).mean() / 2048.0
    emd, n_dup = _assignment_emd(pos_pred / 2.0, pos_gt / 2.0, emd_eps,
                                 emd_iters, phases=emd_phases)
    _warn_duplicates(int(n_dup), pos_pred.shape[0] * pos_pred.shape[1],
                     emd_iters)
    return float(cd), float(emd * 2.0)


def pad_clip_with_appropriate_size(pos_lst, num_points: int = 2048,
                                   rng: Optional[np.random.Generator] = None
                                   ) -> np.ndarray:
    """The action eval's clip preparation: every frame resampled to exactly
    ``num_points`` (a random subset when larger; whole repeats and a random
    residue when smaller), y flipped, :func:`pc_normalize`d. [F,
    num_points, 3] f32."""
    rng = rng or np.random.default_rng()
    clip = []
    for frame in pos_lst:
        p = np.asarray(frame, np.float32).copy()
        if p.shape[0] > num_points:
            r = rng.choice(p.shape[0], size=num_points, replace=False)
        else:
            repeat, residue = divmod(num_points, p.shape[0])
            r = np.concatenate([np.arange(p.shape[0])] * repeat
                               + [rng.choice(p.shape[0], size=residue,
                                             replace=False)])
        p[:, 1] = -p[:, 1]
        clip.append(pc_normalize(p[r])[None])
    return np.concatenate(clip, axis=0)


def cycle_consistency(sr_apply, lowres_pos_left: torch.Tensor,
                      lowres_pos_right: torch.Tensor,
                      highres_advection: torch.Tensor,
                      highres_pos_left: torch.Tensor, cutoff: float,
                      use_vel: bool = False,
                      lowres_vel_left: Optional[torch.Tensor] = None,
                      lowres_vel_right: Optional[torch.Tensor] = None,
                      emd_eps: float = 0.03, emd_iters: int = 500,
                      emd_phases: int = 3) -> Tuple[float, float, float]:
    """Upsample-then-advect against advect-then-upsample.

    ``sr_apply(feature, pos) -> pred_pos [B, M, 3]`` wraps the generator.
    Path 1 upsamples the left frame and moves each predicted particle by
    the ground-truth advection interpolated onto it (capped interpolation,
    cutoff 1.6 ``cutoff``); path 2 upsamples the right frame. Returns the
    (Chamfer / M, mean EMD, MMD) between the two.
    """
    def feats(pos, vel):
        return torch.cat([pos, vel * DT], -1) if use_vel else pos

    pred_left = sr_apply(feats(lowres_pos_left, lowres_vel_left),
                         lowres_pos_left)
    pred_advection = cubic_interpolation(pred_left[0], highres_advection[0],
                                         highres_pos_left[0], 1.6 * cutoff)
    pred_right_advect = pred_left + pred_advection[None]
    pred_right = sr_apply(feats(lowres_pos_right, lowres_vel_right),
                          lowres_pos_right)
    cd = chamfer(pred_right, pred_right_advect).mean() / pred_right.shape[1]
    p, t, _ = _joint_normalize(pred_right, pred_right_advect)
    assign = auction_assignment(p, t, eps=emd_eps, iters=emd_iters,
                                phases=emd_phases)
    matched = torch.gather(t, 1, assign[..., None].expand(-1, -1, 3))
    emd = (p - matched).norm(dim=-1).mean()
    mmd = gaussian_mmd(p, t, blur=0.01).mean()
    return float(cd), float(emd), float(mmd)


def _dense_spline_density(query: np.ndarray, cand: np.ndarray, cutoff: float,
                          device=None) -> np.ndarray:
    """The exact coefficient-1 spline density at each query: the weight sum
    over every candidate within the cutoff (no K cap), from the cell-grid
    kernel's ``den`` output. [Nq, 1].

    The JAX package routes between its block-pruned kernel and a chunked
    dense scan by the blocks each tile needs, because the TPU kernel has a
    block budget; a cell grid has none, and its cost follows the in-radius
    pairs, so this always takes the grid."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query, np.float32), device=dev)[None]
    c = torch.as_tensor(np.asarray(cand, np.float32), device=dev)[None]
    bias = torch.zeros(c.shape[:2], dtype=torch.float32, device=dev)
    vals = torch.zeros(c.shape[:2] + (1,), dtype=torch.float32, device=dev)
    _, den = binned_interp(q, c, vals, cutoff, bias, kind="spline1")
    return (den[0] - 1e-6).cpu().numpy()[:, None]


def _capped_spline_density(query: np.ndarray, cand: np.ndarray,
                           cutoff: float, k: int, device=None) -> np.ndarray:
    """The spline density over each query's k nearest in-radius candidates
    (radius kNN). [Nq, 1]."""
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query, np.float32), device=dev)[None]
    c = torch.as_tensor(np.asarray(cand, np.float32), device=dev)[None]
    d2, _, in_range = radius_mask_knn(q, c, k=k, radius=cutoff)
    ker = spline(torch.sqrt(torch.clamp_min(d2, 0.0)) / cutoff)
    return torch.where(in_range, ker, 0.0).sum(-1).cpu().numpy()[0][:, None]


def get_particle_density(pos: np.ndarray, cutoff: float, k: int = 64,
                         dense: Optional[bool] = None, device=None
                         ) -> np.ndarray:
    """Unnormalised cubic-spline density per particle (coefficient 1, the
    reference's), [N, 1]. ``dense`` (None: on from 20,000 points) sums
    every in-radius neighbour through the cell-grid kernel; otherwise the
    k nearest in-radius neighbours count, which is the same whenever no
    particle has more than k of them."""
    if dense is None:
        dense = pos.shape[0] >= 20000
    if dense:
        return _dense_spline_density(pos, pos, cutoff, device)
    return _capped_spline_density(pos, pos, cutoff, k, device)


def particle_dns2grid_dns(grid_pos: np.ndarray, pcd_pos: np.ndarray,
                          cutoff: float, k: int = 64,
                          dense: Optional[bool] = None, device=None
                          ) -> np.ndarray:
    """The particle cloud's density sampled at grid points, [G, 1];
    ``dense`` as in :func:`get_particle_density` (by the cloud's size)."""
    if dense is None:
        dense = pcd_pos.shape[0] >= 20000
    if dense:
        return _dense_spline_density(grid_pos, pcd_pos, cutoff, device)
    return _capped_spline_density(grid_pos, pcd_pos, cutoff, k, device)


def nearest_set(pcd: np.ndarray, reference_pcd: np.ndarray):
    """Unique nearest-reference indices and their multiplicities."""
    from scipy.spatial import cKDTree

    _, idx = cKDTree(reference_pcd).query(pcd, k=1)
    return np.unique(idx, return_counts=True)


def get_1st_derivative(y: np.ndarray, dt) -> np.ndarray:
    """Temporal gradient of a per-frame signal (``dt`` is passed as numpy's
    ``edge_order``, as in the reference)."""
    return np.gradient(y, edge_order=dt)


def get_2nd_derivative(y: np.ndarray, dt) -> np.ndarray:
    return np.gradient(np.gradient(y, edge_order=dt), edge_order=dt)


def eval_spatial_grid_gradient(field: np.ndarray, grid: np.ndarray):
    """Per-axis spatial gradients of a gridded density field."""
    if field.shape != grid.shape:
        field = field.reshape(grid.shape)
    return (np.gradient(field, axis=0), np.gradient(field, axis=1),
            np.gradient(field, axis=2))


def free_surface_particle_count_diff(pos_pred: np.ndarray, pos_gt: np.ndarray,
                                     radius: float = 0.025) -> int:
    """|#free-surface(pred) - #free-surface(gt)|."""
    fp, fg = free_surface_particle_counts(pos_pred, pos_gt, radius)
    return abs(fp - fg)


def free_surface_particle_counts(pos_pred: np.ndarray, pos_gt: np.ndarray,
                                 radius: float = 0.025) -> tuple:
    """The (pred, gt) free-surface particle counts."""
    fp = get_free_surface_particles(np.asarray(pos_pred), radius)
    fg = get_free_surface_particles(np.asarray(pos_gt), radius)
    return int(fp.shape[0]), int(fg.shape[0])
