"""FlowNet3D-style flow embedding across frames (``tpugan_tpu/nn/flow.py``).

The reference's radius-bounded neighbour search with kNN padding is exactly
plain kNN, so one kNN call serves; the ``radius`` argument has no effect on
the selected neighbours, as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.nn.layers import (BatchNorm, SpectralNorm, dense,
                                        leaky_relu_001, seeded)
from tpugan_tpu_torch.ops.neighbors import group, knn


class FlowEmbedding(nn.Module):
    """Correlate two frames: for each point of frame 1 gather its 32
    nearest points of frame 2, concat [pos_diff, feat2, feat1], then
    (Dense, spectral norm, BatchNorm, leaky ReLU 0.01) per width of
    ``mlp``, then max over the neighbours."""

    def __init__(self, in_features: int, mlp: Sequence[int], nsample: int = 32,
                 spectral_norm: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        self.nsample, self.spectral_norm = nsample, spectral_norm
        self.widths = list(mlp)
        cin = 3 + 2 * in_features
        for i, w in enumerate(mlp):
            self.add_module(f"Dense_{i}", dense(cin, w, False, generator, device))
            if spectral_norm:
                self.add_module(f"SpectralNorm_{i}",
                                SpectralNorm(w, generator, device))
            self.add_module(f"BatchNorm_{i}", BatchNorm(w, device=device))
            cin = w

    def forward(self, pos1, pos2, feat1, feat2, radius: float = 0.0,
                train: bool = False) -> torch.Tensor:
        _, idx = knn(pos1, pos2, k=self.nsample)
        pos_diff = group(pos2, idx) - pos1[:, :, None, :]        # [B, N, S, 3]
        feat2_grouped = group(feat2, idx)                         # [B, N, S, C]
        feat1_tiled = feat1[:, :, None, :].expand_as(feat2_grouped)
        y = torch.cat([pos_diff, feat2_grouped, feat1_tiled], dim=-1)
        for i in range(len(self.widths)):
            w = getattr(self, f"Dense_{i}").weight
            if self.spectral_norm:
                w = getattr(self, f"SpectralNorm_{i}")(w, update_stats=train)
            y = getattr(self, f"BatchNorm_{i}")(torch.matmul(y, w.t()), train)
            y = leaky_relu_001(y)
        return y.amax(dim=2)                                     # [B, N, C']


class FlowModule(nn.Module):
    """Pyramidal pairwise flow mixing over a frame window: at depth d every
    adjacent pair of the feature list is correlated by the depth-d
    FlowEmbedding, shrinking the list by one."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, sequence_length: int,
                 spectral_norm: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if sequence_length < 2:
            raise ValueError("Flow module only accepts sequences of length > 1")
        generator, device = seeded(generator), resolve_device(device)
        self.sequence_length = sequence_length
        depth = sequence_length - 1
        hidden = out_features if depth == 1 else hidden_features
        feat = in_features
        for d in range(depth):
            if d == 0:
                mlp = [in_features, hidden // 2, hidden]
            elif d == depth - 1:
                mlp = [hidden, out_features, out_features]
            else:
                mlp = [hidden, hidden // 2, hidden]
            self.add_module(f"flow_emb_layers_{d}", FlowEmbedding(
                feat, mlp, spectral_norm=spectral_norm, generator=generator,
                device=device))
            feat = mlp[-1]

    def forward(self, feature_lst: List[torch.Tensor],
                pos_lst: List[torch.Tensor], cutoff: float = 0.0,
                train: bool = False) -> torch.Tensor:
        feats = list(feature_lst)
        for d in range(self.sequence_length - 1):
            layer = getattr(self, f"flow_emb_layers_{d}")
            feats = [layer(pos_lst[l], pos_lst[l + 1], feats[l], feats[l + 1],
                           radius=cutoff, train=train)
                     for l in range(len(feats) - 1)]
        return feats[0]
