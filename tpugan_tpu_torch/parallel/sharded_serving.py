"""Point-axis sharded generator serving: one big frame upsampled across
the ranks (``tpugan_tpu/parallel/sharded_serving.py``).

Each rank holds a contiguous N-shard of every frame and runs the
unmodified generator under ``point_shard_axis`` (``ops/neighbors.py``):
the convolutions, the mask head and the expansion are pointwise and stay
local, while every graph build all-gathers its candidate side and every
neighbour gather its table. Per frame: the centroid's partial sums meet
in an all-reduce, the 25-frame mask ring stays sharded on the rank's
device, and the expansion masks the global padding slots. The outputs
equal the unsharded rollout's row for row, up to the order of the
centroid's and the distances' f32 sums.

Entry point: ``cli/rollout.py --shard_points`` under ``torchrun``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from tpugan_tpu_torch import DT, PAD_SENTINEL
from tpugan_tpu_torch.models.generator import (RolloutMaskState, SRNet,
                                               expand_pos_with_masking,
                                               rollout_mask_update)
from tpugan_tpu_torch.ops.neighbors import point_shard_axis
from tpugan_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce_, gather_cat,
                                            rank, require_group, world_size)


def make_sharded_rollout_step(model: SRNet, use_vel: bool, group=DATA_AXIS):
    """Point-sharded twin of ``eval.rollout.make_rollout_step``:
    ``step(state, pos, vel, n_valid, offset) -> (out, valid, state)`` on
    this rank's rows pos / vel [1, N/w, 3], which start at global row
    ``offset``; rows at or past ``n_valid`` are padding, and their output
    slots are reported invalid. No autograd."""
    r = model.upsample_ratio

    @torch.no_grad()
    def step(state, pos, vel, n_valid: int, offset: int):
        nloc = pos.shape[1]
        gidx = offset + torch.arange(nloc, device=pos.device)
        real = (gidx < n_valid)[None, :, None]                # [1, nloc, 1]
        local_sum = torch.where(real, pos, 0.0).sum(1, keepdim=True)
        centroid = all_reduce_(local_sum, group) / float(n_valid)
        pos_n = torch.where(real, pos - centroid, pos)
        feature = torch.cat([pos_n, vel * DT], -1) if use_vel else pos_n
        with point_shard_axis(group):
            edge, mask = model.heads(feature, pos_n)
        mean_mask, state = rollout_mask_update(state, mask, valid=real[..., 0])
        _, padded, valid = expand_pos_with_masking(pos_n, edge, mean_mask, r,
                                                   model.epsilon)
        # local slot i*r+j is copy j of local point i: its global slot is
        # offset*r + i*r + j, and the padding owns the global slots past
        # n_valid*r
        gslot = offset * r + torch.arange(nloc * r, device=pos.device)
        valid = valid & (gslot < n_valid * r)[None]
        out = torch.where(valid[..., None], padded + centroid, padded)
        return out, valid, state

    return step


@torch.no_grad()
def rollout_sequence_sharded(model: SRNet, pos_seq: np.ndarray,
                             vel_seq: Optional[np.ndarray] = None,
                             use_vel: bool = False, history: int = 25,
                             group=DATA_AXIS, max_pending: int = 4
                             ) -> List[np.ndarray]:
    """Point-sharded rollout over a uniform-N sequence pos_seq [T, N, 3],
    the same on every rank. Frames are padded at the 999 sentinel to a
    multiple of ``ALIGN * world`` rows, and each rank runs its contiguous
    rows. Rank 0 gathers every frame's rows and returns the valid points
    of each frame in world coordinates, like ``rollout_sequence_device``;
    the other ranks return an empty list.

    ``max_pending`` frames may be enqueued before the oldest frame's rows
    are gathered and copied to the host; 0 runs dispatch, gather and copy
    frame by frame (the same outputs). Raises without a process group."""
    from tpugan_tpu_torch.eval.rollout import ALIGN, _MAX_GRAPH_K

    require_group("point-sharded serving")
    world, me = world_size(group), rank(group)
    t, n, _ = pos_seq.shape
    if n <= _MAX_GRAPH_K:
        raise ValueError(
            f"frame with {n} points <= the generator's max graph k "
            f"({_MAX_GRAPH_K}); sharded rollout targets big frames")
    if vel_seq is None:
        vel_seq = np.zeros_like(pos_seq)
    n_pad = (-n) % (ALIGN * world)
    nloc = (n + n_pad) // world
    lo, hi = me * nloc, (me + 1) * nloc
    pos_loc = np.full((t, nloc, 3), PAD_SENTINEL, np.float32)
    vel_loc = np.zeros((t, nloc, 3), np.float32)
    real = max(0, min(hi, n) - lo)
    pos_loc[:, :real] = pos_seq[:, lo:lo + real]
    vel_loc[:, :real] = vel_seq[:, lo:lo + real]

    device = next(model.parameters()).device
    step = make_sharded_rollout_step(model, use_vel, group)
    state = RolloutMaskState.create(1, nloc, history, device=device)
    outputs: List[np.ndarray] = []
    pending: List = []

    def drain(keep: int):
        while len(pending) > keep:
            out, valid = pending.pop(0)
            out, valid = gather_cat(out, 1, group), gather_cat(valid, 1, group)
            if me == 0:
                out, valid = out[0].cpu().numpy(), valid[0].cpu().numpy()
                outputs.append(out[valid])

    for f in range(t):
        pos_b = torch.from_numpy(pos_loc[f:f + 1]).to(device)
        vel_b = torch.from_numpy(vel_loc[f:f + 1]).to(device)
        out, valid, state = step(state, pos_b, vel_b, n, lo)
        pending.append((out, valid))
        drain(max_pending)
    drain(0)
    return outputs
