"""Sequence rollout inference (the serving loop of
``tpugan_tpu/eval/rollout.py``).

Per frame: shift to the centroid of the real points, build the input
feature (pos, or pos || vel * DT), run the SRNet heads, clamp the mask and
average it over the 25-frame ring, expand with hard masking, shift back.
The ring lives on the device and its counters on the host, so a frame
enqueues its work without waiting for the previous one.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from tpugan_tpu_torch import DT, PAD_SENTINEL
from tpugan_tpu_torch.models.generator import (RolloutMaskState, SRNet,
                                               expand_pos_with_masking,
                                               rollout_mask_update)

# Frames are sentinel-padded up to a multiple of ALIGN points, so mildly
# ragged sequences share one ring shape. The CUDA kernels take any N; 128
# is a multiple of the kNN kernels' 32-query tile and the smallest step at
# which a frame's graphs reach the approximate kNN (which needs Nc % 128 ==
# 0) when the switch is on; the JAX rollout's 256 is a multiple of it.
# Padding rows sit at the 999 sentinel, far from any normalised cloud, with
# no valid mask, so neither kNN picks them as neighbours of real points and
# real outputs do not change.
ALIGN = 128

# Largest kNN k in the generator: with fewer real points than this,
# sentinel rows would enter real points' neighbour lists.
_MAX_GRAPH_K = 20


def _device_of(model: SRNet) -> torch.device:
    return next(model.parameters()).device


def make_rollout_step(model: SRNet, use_vel: bool):
    """step(state, pos [1, N, 3], vel [1, N, 3], n_valid) ->
    (out [1, N*r, 3], valid [1, N*r], state). Rows past ``n_valid`` are
    padding; their output slots are reported invalid. The step runs without
    autograd: serving records no graph."""
    r = model.upsample_ratio

    @torch.no_grad()
    def step(state, pos, vel, n_valid: int):
        n = pos.shape[1]
        real = (torch.arange(n, device=pos.device) < n_valid)[None, :, None]
        centroid = (torch.where(real, pos, 0.0).sum(1, keepdim=True)
                    / float(n_valid))
        pos_n = torch.where(real, pos - centroid, pos)
        feature = torch.cat([pos_n, vel * DT], -1) if use_vel else pos_n
        edge, mask = model.heads(feature, pos_n)
        # ring writes masked to real rows: a padding row may become real in
        # a later, larger frame, and must not inherit sentinel-made masks
        mean_mask, state = rollout_mask_update(state, mask, valid=real[..., 0])
        _, padded, valid = expand_pos_with_masking(pos_n, edge, mean_mask, r,
                                                   model.epsilon)
        # slots i*r .. i*r+r-1 belong to point i: padding owns the tail
        valid = valid & (torch.arange(valid.shape[1], device=pos.device)
                         < n_valid * r)[None]
        out = torch.where(valid[..., None], padded + centroid, padded)
        return out, valid, state

    return step


def _padded_frame(pos: np.ndarray, vel: Optional[np.ndarray], bucket: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    n = pos.shape[0]
    p = np.full((1, bucket, 3), PAD_SENTINEL, np.float32)
    v = np.zeros((1, bucket, 3), np.float32)
    p[0, :n] = pos
    if vel is not None:
        v[0, :n] = vel
    return (torch.from_numpy(p).to(device),
            torch.from_numpy(v).to(device))


@torch.no_grad()
def rollout_sequence(model: SRNet,
                     frames: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
                     use_vel: bool = False, history: int = 25,
                     max_pending: int = 16) -> List[np.ndarray]:
    """Upsample a sequence of (pos [N, 3], vel [N, 3] or None) frames.

    Frames are padded to a shared bucket (the first frame's count rounded up
    to ``ALIGN``); a later frame larger than the bucket raises, as does a
    padded frame with no more real points than the largest graph k. Up to
    ``max_pending`` frames are in flight before the oldest is fetched (0:
    each frame is fetched before the next is enqueued; the outputs are the
    same). Returns the valid output points of each frame, in world
    coordinates.
    """
    device = _device_of(model)
    step = make_rollout_step(model, use_vel)
    state, bucket = None, None
    pending, outputs = [], []

    def drain(keep: int):
        while len(pending) > keep:
            out, valid = pending.pop(0)
            out, valid = out[0].cpu().numpy(), valid[0].cpu().numpy()
            outputs.append(out[valid])

    for pos, vel in frames:
        n_valid = pos.shape[0]
        if bucket is None:
            bucket = -(-n_valid // ALIGN) * ALIGN
            state = RolloutMaskState.create(1, bucket, history, device=device)
        if n_valid > bucket:
            raise ValueError(f"frame with {n_valid} points exceeds the rollout "
                             f"bucket {bucket} set by the first frame")
        if n_valid <= _MAX_GRAPH_K and bucket > n_valid:
            raise ValueError(f"frame with {n_valid} points <= the generator's "
                             f"max graph k ({_MAX_GRAPH_K}): padding would "
                             f"enter real points' neighbour lists")
        pos_b, vel_b = _padded_frame(pos, vel, bucket, device)
        out, valid, state = step(state, pos_b, vel_b, n_valid)
        pending.append((out, valid))
        drain(max_pending)
    drain(0)
    return outputs


@torch.no_grad()
def rollout_sequence_device(model: SRNet, pos_seq: np.ndarray,
                            vel_seq: Optional[np.ndarray] = None,
                            use_vel: bool = False, history: int = 25,
                            chunk: int = 100) -> List[np.ndarray]:
    """Rollout over a uniform-N sequence pos_seq [T, N, 3]: one copy to the
    device per chunk of frames, a loop over the chunk's frames with no host
    sync, and one copy back per chunk."""
    device = _device_of(model)
    t, n, _ = pos_seq.shape
    if vel_seq is None:
        vel_seq = np.zeros_like(pos_seq)
    bucket = -(-n // ALIGN) * ALIGN
    if n <= _MAX_GRAPH_K and bucket > n:
        raise ValueError(f"frames of {n} points <= the generator's max graph "
                         f"k ({_MAX_GRAPH_K}) cannot be padded")
    step = make_rollout_step(model, use_vel)
    state = RolloutMaskState.create(1, bucket, history, device=device)
    outputs = []
    for c in range(0, t, chunk):
        pos_c = np.full((min(chunk, t - c), bucket, 3), PAD_SENTINEL, np.float32)
        vel_c = np.zeros_like(pos_c)
        pos_c[:, :n] = pos_seq[c:c + chunk]
        vel_c[:, :n] = vel_seq[c:c + chunk]
        pos_d = torch.from_numpy(pos_c).to(device)
        vel_d = torch.from_numpy(vel_c).to(device)
        outs, valids = [], []
        for f in range(pos_d.shape[0]):
            out, valid, state = step(state, pos_d[f:f + 1], vel_d[f:f + 1], n)
            outs.append(out[0])
            valids.append(valid[0])
        outs = torch.stack(outs).cpu().numpy()
        valids = torch.stack(valids).cpu().numpy()
        outputs.extend(o[v] for o, v in zip(outs, valids))
    return outputs
