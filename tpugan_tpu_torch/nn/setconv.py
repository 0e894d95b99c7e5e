"""PointNet++ set abstraction, single- and multi-scale
(``tpugan_tpu/nn/setconv.py``).

FPS-downsample centres (invalid / 999-sentinel points are never picked, the
deterministic replacement for the reference's dummy-resampling loop),
ball-query and group neighbourhoods, shared MLP, max-pool per
neighbourhood. ``npoint=None`` pools one group over the whole cloud.
Multi-scale grouping (``SetConv.msg``, the reference's ``MSGSetConv``)
groups each scale at its own radius and sample count around the same
centres, runs its own ``SharedMLP_i`` and concatenates the scales'
pooled features in scale order.

The shared MLP and the pool run as one fused op (the pooled-MLP kernels) at
eval everywhere, and in training where ``fused_train`` is set (the fluid
spatial critic's stages), as in the JAX package; otherwise as the plain
grouped stack and ``amax``. Under ``stat_groups`` with G > 1 (a critic's
stacked apply) every stage takes the plain stack: the kernel's batch
moments pool all rows, and the stack's ``BatchNorm`` keeps each block's.
Under ``cross_rank_stats`` (a data-parallel step at more than one rank)
the fused stages keep the kernel, which sums its moments over the ranks.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.nn.layers import (SharedMLP, fusable_stats, relu,
                                        seeded)
from tpugan_tpu_torch.ops.neighbors import (fps, gather, group_all,
                                            query_and_group)


class SetConv(nn.Module):
    """Set abstraction, single-scale grouping by default. ``bn`` (the JAX
    package's, default True, which every critic uses): batch-normalised,
    bias-free MLP layers; False: norm-free layers with a Dense bias
    (``use_bias = not bn``). ``mlp`` lists the MLP output widths; the input
    width is 3 + the feature width (``use_xyz``). The fused op runs at eval
    and, with ``fused_train``, in training, outside ``stat_groups`` with
    G > 1 (under ``cross_rank_stats`` too).

    ``mlps`` / ``radii`` / ``nsamples`` (lists, one entry a scale; given in
    place of ``mlp`` / ``radius`` / ``nsample``): multi-scale grouping, one
    ``SharedMLP_i`` a scale (see :meth:`msg`). Every scale takes the fused
    op where a single-scale stage would."""

    def __init__(self, in_features: int, mlp: Optional[Sequence[int]] = None,
                 npoint: Optional[int] = None, radius: Optional[float] = None,
                 nsample: Optional[int] = None, mask_dummy: bool = False,
                 bn: bool = True, use_xyz: bool = True,
                 spectral_norm: bool = True, act: Callable = relu,
                 fused_train: bool = False,
                 generator: Optional[torch.Generator] = None, device=None,
                 mlps: Optional[Sequence[Sequence[int]]] = None,
                 radii: Optional[Sequence[Optional[float]]] = None,
                 nsamples: Optional[Sequence[Optional[int]]] = None):
        super().__init__()
        if mlps is None:
            mlps, radii, nsamples = [mlp], [radius], [nsample]
        elif mlp is not None or len({len(mlps), len(radii or ()),
                                     len(nsamples or ())}) != 1:
            raise ValueError("SetConv: give mlp, or mlps with as many radii "
                             "and nsamples")
        self.npoint = npoint
        self.radii, self.nsamples = list(radii), list(nsamples)
        self.mask_dummy, self.use_xyz = mask_dummy, use_xyz
        self.fused_train = fused_train
        generator, device = seeded(generator), resolve_device(device)
        for i, widths in enumerate(mlps):
            self.add_module(f"SharedMLP_{i}", SharedMLP(
                in_features + (3 if use_xyz else 0), widths, act=act,
                norm="batch" if bn else "none", spectral_norm=spectral_norm,
                use_bias=not bn, generator=generator, device=device))

    @classmethod
    def msg(cls, in_features: int, mlps: Sequence[Sequence[int]],
            npoint: Optional[int], radii: Sequence[Optional[float]],
            nsamples: Sequence[Optional[int]], **kw) -> "SetConv":
        """Multi-scale grouping (the reference's ``MSGSetConv``; the JAX
        package's ``SetConv(mlps=..., radii=..., nsamples=...)``)."""
        return cls(in_features, npoint=npoint, mlps=mlps, radii=radii,
                   nsamples=nsamples, **kw)

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
        [B, npoint, 3] or None, pooled features [B, npoint or 1, C'], the
        scales' widths concatenated)."""
        if self.npoint is not None:
            if centers is None:
                centers = self.fps_centers(xyz, valid)
            new_xyz = gather(xyz, centers)
        else:
            new_xyz = None
        fused = ((not train) or self.fused_train) and fusable_stats()
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            if new_xyz is not None:
                grouped = query_and_group(xyz, new_xyz, features, radius,
                                          nsample, use_xyz=self.use_xyz,
                                          c_valid=valid)
            else:
                grouped = group_all(xyz, features, use_xyz=self.use_xyz)
            mlp = getattr(self, f"SharedMLP_{i}")
            outs.append(mlp.pooled(grouped, train) if fused
                        else mlp(grouped, train).amax(dim=2))
        return new_xyz, outs[0] if len(outs) == 1 else torch.cat(outs, -1)
