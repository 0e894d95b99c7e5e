"""PointNet++ set abstraction, single-scale (``tpugan_tpu/nn/setconv.py``).

FPS-downsample centres (invalid / 999-sentinel points are never picked, the
deterministic replacement for the reference's dummy-resampling loop),
ball-query and group neighbourhoods, shared MLP, max-pool per
neighbourhood. ``npoint=None`` pools one group over the whole cloud.

The shared MLP and the pool run as one fused op (the pooled-MLP kernels) at
eval everywhere, and in training where ``fused_train`` is set (the fluid
spatial critic's stages), as in the JAX package; otherwise as the plain
grouped stack and ``amax``. Under ``stat_groups`` with G > 1 (a critic's
stacked apply) every stage takes the plain stack: the kernel's batch
moments pool all rows, and the stack's ``BatchNorm`` keeps each block's.
So does every stage under ``cross_rank_stats`` (a data-parallel step at
more than one rank): the kernel's moments are this rank's rows alone.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.nn.layers import (SharedMLP, local_batch_stats, relu,
                                        seeded)
from tpugan_tpu_torch.ops.neighbors import (fps, gather, group_all,
                                            query_and_group)


class SetConv(nn.Module):
    """Single-scale-grouping set abstraction. ``bn`` (the JAX package's,
    default True, which every critic uses): batch-normalised, bias-free MLP
    layers; False: norm-free layers with a Dense bias (``use_bias = not
    bn``). ``mlp`` lists the MLP output widths; the input width is 3 + the
    feature width (``use_xyz``). The fused op runs at eval and, with
    ``fused_train``, in training, outside ``stat_groups`` (G = 1) and
    ``cross_rank_stats``."""

    def __init__(self, in_features: int, mlp: Sequence[int],
                 npoint: Optional[int] = None, radius: Optional[float] = None,
                 nsample: Optional[int] = None, mask_dummy: bool = False,
                 bn: bool = True, use_xyz: bool = True,
                 spectral_norm: bool = True, act: Callable = relu,
                 fused_train: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mask_dummy, self.use_xyz = mask_dummy, use_xyz
        self.fused_train = fused_train
        self.SharedMLP_0 = SharedMLP(
            in_features + (3 if use_xyz else 0), mlp, act=act,
            norm="batch" if bn else "none", spectral_norm=spectral_norm,
            use_bias=not bn, generator=seeded(generator),
            device=resolve_device(device))

    def fps_centers(self, xyz: torch.Tensor,
                    valid: Optional[torch.Tensor] = None
                    ) -> Optional[torch.Tensor]:
        """The FPS centre indices this stage would select for ``xyz``
        ([B, npoint] int64, None for global pooling). Rows are independent,
        so callers may stack several clouds into one call."""
        if self.npoint is None:
            return None
        npoint = min(self.npoint, xyz.shape[1])
        return fps(xyz, npoint, valid=valid if self.mask_dummy else None)

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None, train: bool = False,
                centers: Optional[torch.Tensor] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """xyz [B, N, 3], features [B, N, C], valid [B, N] -> (new_xyz
        [B, npoint, 3] or None, pooled features [B, npoint or 1, C'])."""
        if self.npoint is not None:
            if centers is None:
                centers = self.fps_centers(xyz, valid)
            new_xyz = gather(xyz, centers)
            grouped = query_and_group(xyz, new_xyz, features, self.radius,
                                      self.nsample, use_xyz=self.use_xyz,
                                      c_valid=valid)
        else:
            new_xyz = None
            grouped = group_all(xyz, features, use_xyz=self.use_xyz)
        if ((not train) or self.fused_train) and local_batch_stats():
            return new_xyz, self.SharedMLP_0.pooled(grouped, train)
        return new_xyz, self.SharedMLP_0(grouped, train).amax(dim=2)
