"""The fluid critics (``tpugan_tpu/models/discriminator.py``): the spatial
critic on one frame and the temporal critic over a frame window, with their
scoring head. Channels-last; hard-masked (999-sentinel) generator outputs
enter through ``valid`` masks of the first (mask_dummy) stage.

Every call in training mode advances each spectral norm and BatchNorm it
passes through, in call order: the temporal critic runs ``sa1`` and
``sa2`` once per frame, so their spectral norms advance three times per
tower call, as the JAX package's per-frame loop does. The frame-stacked
variant (``stack_frames`` / ``--fast_d``) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.nn.flow import FlowModule
from tpugan_tpu_torch.nn.layers import (BatchNorm, SpectralNorm, dense,
                                        leaky_relu_001, seeded)
from tpugan_tpu_torch.nn.setconv import SetConv

# the critics' scoring heads: (hidden widths, dropout rates)
FC_WIDTHS, FC_DROPOUT = (256, 64), (0.2, 0.0)


def _stacked_fps(sa: SetConv, pos_lst, valid_lst):
    """FPS centres of a per-frame stage for every frame in one call over the
    frame-stacked rows (rows are independent: the same selections)."""
    f = len(pos_lst)
    if sa.npoint is None or f == 1:
        return [None] * f
    if any(p.shape != pos_lst[0].shape for p in pos_lst):
        return [None] * f
    valid = None
    if sa.mask_dummy and valid_lst is not None:
        if any(v is None for v in valid_lst):
            return [None] * f
        valid = torch.cat(valid_lst, 0)
    return list(torch.chunk(sa.fps_centers(torch.cat(pos_lst, 0), valid), f, 0))


def dropout_multipliers(shape, p: float,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
    """flax dropout as a multiplier: 1 / (1 - p) where a unit is kept
    (probability 1 - p), 0 where it is dropped."""
    keep = torch.rand(shape, generator=generator) < 1.0 - p
    return torch.where(keep, 1.0 / (1.0 - p), 0.0).to(device)


class FCHead(nn.Module):
    """Spectral-normed Dense / BatchNorm / leaky ReLU 0.01 / dropout layers
    and a spectral-normed Dense to ``out_features``.

    Dropout follows flax: a kept unit is rescaled by 1 / keep. Its
    multipliers [B, width] (0 for a dropped unit, 1 / keep for a kept one;
    all ones turn dropout off) come from ``keep``, a list with one per
    dropout layer (e.g. from the train step's draws), or else are drawn
    from ``generator``.
    """

    def __init__(self, in_features: int, widths: Sequence[int] = FC_WIDTHS,
                 dropouts: Sequence[float] = FC_DROPOUT, out_features: int = 1,
                 spectral_norm: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        self.dropouts, self.spectral_norm = list(dropouts), spectral_norm
        sizes = list(widths) + [out_features]
        for i, w in enumerate(sizes):
            self.add_module(f"Dense_{i}", dense(in_features, w, True, generator,
                                                device))
            if spectral_norm:
                self.add_module(f"SpectralNorm_{i}",
                                SpectralNorm(w, generator, device))
            if i < len(widths):
                self.add_module(f"BatchNorm_{i}", BatchNorm(w, device=device))
            in_features = w

    def dropout_widths(self) -> List[int]:
        """Widths of the layers with dropout (one keep-mask each)."""
        return [getattr(self, f"Dense_{i}").out_features
                for i, p in enumerate(self.dropouts) if p > 0]

    def _dense(self, i, x, train):
        lin = getattr(self, f"Dense_{i}")
        w = lin.weight
        if self.spectral_norm:
            w = getattr(self, f"SpectralNorm_{i}")(w, update_stats=train)
        return torch.nn.functional.linear(x, w, lin.bias)

    def forward(self, x: torch.Tensor, train: bool = False,
                keep: Optional[List[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        masks = list(keep) if keep is not None else None
        for i, p in enumerate(self.dropouts):
            x = leaky_relu_001(getattr(self, f"BatchNorm_{i}")(
                self._dense(i, x, train), train))
            if p > 0 and train:
                x = x * (masks.pop(0) if masks is not None
                         else dropout_multipliers(x.shape, p, generator,
                                                  x.device))
        return self._dense(len(self.dropouts), x, train)


class FluidSpatialDis(nn.Module):
    """3-level SSG set-abstraction critic for single fluid frames; every
    stage takes the fused pooled-MLP path in training (``fused_train``)."""

    def __init__(self, spectral_norm: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        kw = dict(generator=generator, device=device)
        self.sa_0 = SetConv(3, [64, 128], npoint=1024, radius=0.15, nsample=32,
                            mask_dummy=True, act=leaky_relu_001,
                            fused_train=True, **kw)
        self.sa_1 = SetConv(128, [128, 128], npoint=512, radius=0.30,
                            nsample=32, act=leaky_relu_001, fused_train=True,
                            **kw)
        self.sa_2 = SetConv(128, [128, 256], npoint=128, radius=0.60,
                            nsample=16, act=leaky_relu_001, fused_train=True,
                            **kw)
        self.sa_pooling = SetConv(256, [256, 256], spectral_norm=spectral_norm,
                                  fused_train=True, **kw)
        self.fc = FCHead(256, **kw)

    def forward(self, pos: torch.Tensor, valid: Optional[torch.Tensor] = None,
                train: bool = False, keep: Optional[List[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pos [B, N, 3], valid [B, N] -> scores [B, 1]."""
        feature = None
        for i, sa in enumerate((self.sa_0, self.sa_1, self.sa_2)):
            pos, feature = sa(pos, pos if feature is None else feature,
                              valid=valid if i == 0 else None, train=train)
        _, feature = self.sa_pooling(pos, feature, train=train)
        return self.fc(feature[:, 0, :], train, keep, generator)


class FluidTempoDis(nn.Module):
    """Temporal critic over a frame window: two SSG stages per frame (their
    FPS centres stacked over the frames), FlowEmbedding mixing, SA pooling
    and a scoring head. ``in_features`` is the per-point feature width
    (3: positions or advection vectors)."""

    def __init__(self, sequence_length: int, spectral_norm: bool = True,
                 in_features: int = 3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        sn = spectral_norm
        kw = dict(generator=generator, device=device)
        self.sa1 = SetConv(in_features, [64, 128], npoint=1024, radius=0.10,
                           nsample=32, mask_dummy=True, spectral_norm=sn,
                           act=leaky_relu_001, **kw)
        self.sa2 = SetConv(128, [128, 256], npoint=256, radius=0.20,
                           nsample=32, spectral_norm=sn, act=leaky_relu_001,
                           **kw)
        self.flow_module = FlowModule(256, 256, 256, sequence_length,
                                      spectral_norm=sn, **kw)
        self.sa_pooling = SetConv(256, [256, 256], spectral_norm=sn,
                                  act=leaky_relu_001, **kw)
        self.fc = FCHead(256, spectral_norm=sn, **kw)

    def forward(self, pos_lst: List[torch.Tensor], cutoff: float,
                feat_lst: Optional[List[torch.Tensor]] = None,
                valid_lst: Optional[List[Optional[torch.Tensor]]] = None,
                train: bool = False, keep: Optional[List[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pos_lst / feat_lst: one [B, N, 3] per frame -> scores [B, 1]."""
        c1 = _stacked_fps(self.sa1, pos_lst, valid_lst)
        mid_p, mid_f = [], []
        for i, pos in enumerate(pos_lst):
            p, f = self.sa1(pos, feat_lst[i] if feat_lst is not None else pos,
                            valid=valid_lst[i] if valid_lst is not None else None,
                            train=train, centers=c1[i])
            mid_p.append(p)
            mid_f.append(f)
        c2 = _stacked_fps(self.sa2, mid_p, None)
        poss, feats = [], []
        for i in range(len(pos_lst)):
            p, f = self.sa2(mid_p[i], mid_f[i], train=train, centers=c2[i])
            poss.append(p)
            feats.append(f)
        feature = self.flow_module(feats, poss, 20 * cutoff, train=train)
        _, feature = self.sa_pooling(poss[0], feature, train=train)
        return self.fc(feature[:, 0, :], train, keep, generator)


def dropout_widths(model: nn.Module) -> List[int]:
    """Widths of a critic's dropout layers, one multiplier tensor each."""
    return model.fc.dropout_widths()
