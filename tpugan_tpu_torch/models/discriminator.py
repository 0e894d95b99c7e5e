"""The critics (``tpugan_tpu/models/discriminator.py``): the fluid spatial
critic on one frame and the fluid temporal critic over a frame window, with
their scoring head; the action workload's spatial and temporal critics and
the transfer classifier that probes the latter's features
(``ActionSpatialDis``, ``ActionTempoDis``, ``ActionCls``,
``transfer_feature_extractor``). Channels-last; hard-masked (999-sentinel)
generator outputs enter through ``valid`` masks of the first stage.

Every call in training mode advances each spectral norm and BatchNorm it
passes through, in call order: the temporal critic runs ``sa1`` and
``sa2`` once per frame, so their spectral norms advance three times per
tower call, as the JAX package's per-frame loop does.

``stack_frames`` (the trainers' ``--fast_d``) runs the temporal towers'
per-frame ``sa1`` and ``sa2`` as one apply on the frames stacked along the
batch axis, under ``stat_groups(F * outer)``: every frame (times every
block of an enclosing ``stat_groups``, e.g. the fake and real halves of a
stacked critic update) keeps its own batch moments, and the running
averages replay in that block order (frame-major). Each spectral norm then
advances once per stacked apply, not once per frame. The scoring heads'
and the flow embeddings' batch norms honour the enclosing groups.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.nn.flow import FlowModule
from tpugan_tpu_torch.nn.layers import (BatchNorm, SpectralNorm,
                                        current_stat_groups, dense,
                                        leaky_relu_001, seeded, stat_groups)
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


def _stacked_sa_frames(sa1: SetConv, sa2: SetConv, pos_lst, feat_lst,
                       valid_lst, train: bool):
    """A temporal tower's per-frame ``sa1`` then ``sa2`` as one apply on the
    frames stacked along the batch axis (the JAX package's
    ``_stacked_sa_frames``): the convolutions and gathers are
    row-independent, and the batch norms run under ``stat_groups(F *
    outer)`` so each frame (of each enclosing block) keeps its own moments.
    Frames of unequal shape and valid masks that are neither all given nor
    all absent raise. Returns the per-frame (positions, features) lists."""
    f = len(pos_lst)
    if any(p.shape != pos_lst[0].shape for p in pos_lst):
        raise ValueError("stack_frames requires uniform frame shapes")
    spos = torch.cat(pos_lst, 0)
    sfeat = torch.cat(feat_lst, 0) if feat_lst is not None else spos
    svalid = None
    if valid_lst is not None:
        if any(v is None for v in valid_lst):
            raise ValueError("stack_frames needs all-or-none valid masks")
        svalid = torch.cat(valid_lst, 0)
    with stat_groups(f * current_stat_groups()):
        p1, f1 = sa1(spos, sfeat, valid=svalid, train=train)
        p2, f2 = sa2(p1, f1, train=train)
    return list(torch.chunk(p2, f, 0)), list(torch.chunk(f2, f, 0))


def _per_frame_sa(sa1: SetConv, sa2: SetConv, pos_lst, feat_lst, valid_lst,
                  train: bool):
    """The per-frame loop of ``sa1`` then ``sa2`` (each stage's FPS
    centres stacked over the frames). Returns the per-frame (positions,
    features) lists."""
    c1 = _stacked_fps(sa1, pos_lst, valid_lst)
    mid_p, mid_f = [], []
    for i, pos in enumerate(pos_lst):
        p, f = sa1(pos, feat_lst[i] if feat_lst is not None else pos,
                   valid=valid_lst[i] if valid_lst is not None else None,
                   train=train, centers=c1[i])
        mid_p.append(p)
        mid_f.append(f)
    c2 = _stacked_fps(sa2, mid_p, None)
    poss, feats = [], []
    for i in range(len(pos_lst)):
        p, f = sa2(mid_p[i], mid_f[i], train=train, centers=c2[i])
        poss.append(p)
        feats.append(f)
    return poss, feats


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

    Its batch norms honour ``stat_groups``. Dropout follows flax: a kept
    unit is rescaled by 1 / keep. Its multipliers [B, width] (0 for a
    dropped unit, 1 / keep for a kept one; all ones turn dropout off) come
    from ``keep``, a list with one per dropout layer (e.g. from the train
    step's draws), or else are drawn from ``generator``.
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
        return [w for w, _ in self.dropout_layers()]

    def dropout_layers(self) -> List[Tuple[int, float]]:
        """(width, rate) of each layer with dropout, in call order: the
        keep-masks ``keep`` takes are [B, width] multipliers drawn at that
        rate (the action heads drop 0.3, then 0.1)."""
        return [(getattr(self, f"Dense_{i}").out_features, p)
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
                generator: Optional[torch.Generator] = None,
                stack_frames: bool = False) -> torch.Tensor:
        """pos_lst / feat_lst: one [B, N, 3] per frame -> scores [B, 1];
        ``stack_frames``: sa1 and sa2 as one stacked apply."""
        frames = _stacked_sa_frames if stack_frames else _per_frame_sa
        poss, feats = frames(self.sa1, self.sa2, pos_lst, feat_lst, valid_lst,
                             train)
        feature = self.flow_module(feats, poss, 20 * cutoff, train=train)
        _, feature = self.sa_pooling(poss[0], feature, train=train)
        return self.fc(feature[:, 0, :], train, keep, generator)


def dropout_widths(model: nn.Module) -> List[int]:
    """Widths of a critic's dropout layers, one multiplier tensor each."""
    return model.fc.dropout_widths()


def dropout_layers(model: nn.Module) -> List[Tuple[int, float]]:
    """(width, rate) of a critic's dropout layers (``FCHead.dropout_layers``)."""
    return model.fc.dropout_layers()


class ActionTempoTower(nn.Module):
    """The tower shared by :class:`ActionTempoDis` and :class:`ActionCls`:
    two SSG stages per frame (ReLU; their FPS centres stacked over the
    frames), FlowEmbedding mixing and SA pooling to one feature per clip,
    [B, pool_mlp[-1]]. The cutoff goes to the flow module as given."""

    def __init__(self, sequence_length: int, spectral_norm: bool,
                 pool_mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        sn = spectral_norm
        kw = dict(generator=seeded(generator), device=resolve_device(device))
        self.sa1 = SetConv(3, [64, 64, 128], npoint=512, radius=0.8,
                           nsample=64, spectral_norm=sn, **kw)
        self.sa2 = SetConv(128, [128, 256], npoint=256, radius=1.2,
                           nsample=32, spectral_norm=sn, **kw)
        self.flow_module = FlowModule(256, 256, 256, sequence_length,
                                      spectral_norm=sn, **kw)
        self.sa_pooling = SetConv(256, pool_mlp, spectral_norm=sn, **kw)

    def forward(self, pos_lst: List[torch.Tensor], cutoff: float,
                valid_lst: Optional[List[Optional[torch.Tensor]]] = None,
                train: bool = False, stack_frames: bool = False
                ) -> torch.Tensor:
        frames = _stacked_sa_frames if stack_frames else _per_frame_sa
        poss, feats = frames(self.sa1, self.sa2, pos_lst, None, valid_lst,
                             train)
        feature = self.flow_module(feats, poss, cutoff, train=train)
        _, feature = self.sa_pooling(poss[0], feature, train=train)
        return feature[:, 0, :]


ACTION_FC_WIDTHS, ACTION_FC_DROPOUT = (256, 64), (0.3, 0.1)


class ActionSpatialDis(nn.Module):
    """Single-frame critic of the action workload (reference
    discriminator.py:405-470): three spectral-normed SSG stages with ReLU
    and no dummy masking (512 centres in radius 0.3, 256 in 0.6, 128 in
    1.0, 32 samples each), a [256, 512] SA pooling and a spectral-normed
    scoring head dropping 0.3 and 0.1. In training its SetConvs run the
    plain grouped stacks (no ``fused_train``, as in the JAX package)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=seeded(generator), device=resolve_device(device))
        self.sa_0 = SetConv(3, [64, 64, 128], npoint=512, radius=0.3,
                            nsample=32, **kw)
        self.sa_1 = SetConv(128, [128, 128], npoint=256, radius=0.6,
                            nsample=32, **kw)
        self.sa_2 = SetConv(128, [128, 256], npoint=128, radius=1.0,
                            nsample=32, **kw)
        self.sa_pooling = SetConv(256, [256, 512], **kw)
        self.fc = FCHead(512, ACTION_FC_WIDTHS, ACTION_FC_DROPOUT, **kw)

    def forward(self, pos: torch.Tensor, valid: Optional[torch.Tensor] = None,
                train: bool = False, keep: Optional[List[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pos [B, N, 3], valid [B, N] (the first stage's ball-query
        candidates; its FPS masks nothing) -> scores [B, 1]."""
        feature = None
        for i, sa in enumerate((self.sa_0, self.sa_1, self.sa_2)):
            pos, feature = sa(pos, pos if feature is None else feature,
                              valid=valid if i == 0 else None, train=train)
        _, feature = self.sa_pooling(pos, feature, train=train)
        return self.fc(feature[:, 0, :], train, keep, generator)


class ActionTempoDis(nn.Module):
    """Temporal critic of the action workload: the tower with spectral
    norms, a [256, 512] SA pooling and a spectral-normed scoring head."""

    def __init__(self, sequence_length: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=seeded(generator), device=resolve_device(device))
        self.tower = ActionTempoTower(sequence_length, True, [256, 512], **kw)
        self.fc = FCHead(512, ACTION_FC_WIDTHS, ACTION_FC_DROPOUT, **kw)

    def forward(self, pos_lst: List[torch.Tensor], cutoff: float,
                valid_lst: Optional[List[Optional[torch.Tensor]]] = None,
                train: bool = False, keep: Optional[List[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                stack_frames: bool = False) -> torch.Tensor:
        """pos_lst: one [B, N, 3] per frame -> scores [B, 1]."""
        feature = self.tower(pos_lst, cutoff, valid_lst, train, stack_frames)
        return self.fc(feature, train, keep, generator)


class ActionCls(nn.Module):
    """Transfer classifier probing the temporal critic's features: the
    tower without spectral norm, a [512, 512] SA pooling and a
    ``num_classes``-way head. ``infer`` is its serving call: eval mode, no
    autograd, softmax probabilities."""

    def __init__(self, sequence_length: int, num_classes: int = 20,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=seeded(generator), device=resolve_device(device))
        self.tower = ActionTempoTower(sequence_length, False, [512, 512], **kw)
        self.fc = FCHead(512, ACTION_FC_WIDTHS, ACTION_FC_DROPOUT,
                         out_features=num_classes, spectral_norm=False, **kw)

    def forward(self, pos_lst: List[torch.Tensor], cutoff: float,
                train: bool = False, keep: Optional[List[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pos_lst: one [B, N, 3] per frame -> logits [B, num_classes]."""
        return self.fc(self.tower(pos_lst, cutoff, train=train), train, keep,
                       generator)

    @torch.no_grad()
    def infer(self, pos_lst: List[torch.Tensor], cutoff: float) -> torch.Tensor:
        """Class probabilities [B, num_classes] at eval (the fused
        pooled-MLP kernel in every SetConv)."""
        return torch.softmax(self(pos_lst, cutoff, train=False), -1)


TRANSFERRED = ("tower.sa1.", "tower.sa2.", "tower.flow_module.")

_Weights = Union[nn.Module, Dict[str, torch.Tensor]]


def transfer_feature_extractor(cls: _Weights, dis: _Weights) -> _Weights:
    """Copy a trained temporal critic's ``tower.sa1``, ``tower.sa2`` and
    ``tower.flow_module`` parameters and BatchNorm running moments into a
    classifier, wherever the name and the shape match (the reference's
    ``init_feature_extractor``). The raw (not spectral-normalised) kernels
    go across, as flax stores them; spectral-norm state has no counterpart
    in the classifier and stays behind.

    ``cls`` and ``dis`` are modules or state_dicts. A module ``cls`` is
    filled in place and returned; a state_dict ``cls`` gives a new one."""
    src = dis.state_dict() if isinstance(dis, nn.Module) else dis
    dst = cls.state_dict() if isinstance(cls, nn.Module) else dict(cls)
    moved = {k: v for k, v in src.items()
             if k.startswith(TRANSFERRED) and k in dst
             and tuple(dst[k].shape) == tuple(v.shape)}
    if not isinstance(cls, nn.Module):
        dst.update({k: v.detach().clone() for k, v in moved.items()})
        return dst
    with torch.no_grad():
        for k, v in moved.items():
            dst[k].copy_(v)
    return cls
