"""The masked upsampling generator SRNet and its rollout mask ring
(``tpugan_tpu/models/generator.py``). ``train=False`` is the serving
forward (fused EdgeConv kernels, no autograd); ``train=True`` the training
forward (differentiable: the grouped EdgeConv formulation, or with
``fused_train`` the fused kernels and their backward). The generator has no
batch statistics, so several frames may run as one batch.

Shapes are channels-last. Copies of input point i occupy output slots
i*r .. i*r + r - 1; pruned copies are parked at the 999 sentinel and
reported through a boolean ``valid`` mask, so every shape stays fixed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_tpu_torch import PAD_SENTINEL, resolve_device
from tpugan_tpu_torch.nn.edgeconv import EdgeConv, IDGCNLayer
from tpugan_tpu_torch.nn.layers import (ConvLayer, SharedMLP, promoted_dtype,
                                        dense, seeded)
from tpugan_tpu_torch.ops.neighbors import graph_knn


def _head(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A biased f32 head: bf16 activations are promoted back to f32."""
    return F.linear(x.to(promoted_dtype(x, None)), lin.weight, lin.bias)


class GCNFeatureExtractor(nn.Module):
    """EdgeConv (k=20) then ``layer_num - 1`` IDGCN layers of width
    ``node_emb_dim``; returns the concatenation of the IDGCN outputs,
    [B, N, (layer_num - 1) * node_emb_dim]."""

    def __init__(self, in_feats: int, layer_num: int, node_emb_dim: int,
                 dtype=None, fused_train=False, generator=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, fused_train=fused_train,
                  generator=seeded(generator), device=resolve_device(device))
        self.EdgeConv_0 = EdgeConv(in_feats, node_emb_dim, k=20, **kw)
        self.idgcn = [f"IDGCNLayer_{l}" for l in range(layer_num - 1)]
        for name in self.idgcn:
            self.add_module(name, IDGCNLayer(node_emb_dim, node_emb_dim, **kw))

    def forward(self, feature, pos=None, shared_idx=None, train=False):
        x = self.EdgeConv_0(feature, pos=pos, idx=shared_idx, train=train)
        outs = []
        for name in self.idgcn:
            x = getattr(self, name)(x, shared_idx=shared_idx, train=train)
            outs.append(x)
        return torch.cat(outs, dim=-1)


class UpsamplingModule(nn.Module):
    """Offset head: two (bottleneck conv, EdgeConv) stages with k=12 then
    k=4, a SharedMLP and a biased f32 projection to 3r offsets."""

    def __init__(self, in_dim: int, upsample_ratio: int, dtype=None,
                 fused_train=False, generator=None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        kw = dict(dtype=dtype, generator=generator, device=device)
        out_dim = 3 * upsample_ratio
        self.ConvLayer_0 = ConvLayer(in_dim, in_dim // 4, **kw)
        self.EdgeConv_0 = EdgeConv(in_dim // 4, in_dim, k=12,
                                   fused_train=fused_train, **kw)
        self.ConvLayer_1 = ConvLayer(in_dim, in_dim // 4, **kw)
        self.EdgeConv_1 = EdgeConv(in_dim // 4, in_dim, k=4,
                                   fused_train=fused_train, **kw)
        self.SharedMLP_0 = SharedMLP(in_dim, [out_dim // 2, out_dim], **kw)
        self.Dense_0 = dense(out_dim, out_dim, True, generator, device)

    def forward(self, feature, shared_idx=None, train=False):
        feature = self.EdgeConv_0(self.ConvLayer_0(feature), idx=shared_idx,
                                  train=train)
        feature = self.EdgeConv_1(self.ConvLayer_1(feature), idx=shared_idx,
                                  train=train)
        return _head(self.Dense_0, self.SharedMLP_0(feature))      # [B, N, 3r]


class BinaryMaskingModule(nn.Module):
    """Keep-probability head: like the offset head, but the second EdgeConv
    (k=8) sums without the inner MLP, and the decoder ends in a ReLU
    scalar. The last projection starts at bias 0.1 so the ReLU head is
    alive at initialisation."""

    def __init__(self, in_dim: int, dtype=None, fused_train=False,
                 generator=None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.ConvLayer_0 = ConvLayer(in_dim, in_dim // 4, **kw)
        self.EdgeConv_0 = EdgeConv(in_dim // 4, in_dim, k=12,
                                   fused_train=fused_train, **kw)
        self.ConvLayer_1 = ConvLayer(in_dim, in_dim // 4, **kw)
        self.EdgeConv_1 = EdgeConv(in_dim // 4, in_dim, k=8, aggregate="sum",
                                   mlp_layer=False, fused_train=fused_train,
                                   **kw)
        self.SharedMLP_0 = SharedMLP(in_dim, [in_dim // 2, in_dim // 4], **kw)
        self.Dense_0 = dense(in_dim // 4, 1, True, generator, device,
                             scale=0.01, bias_init=0.1)

    def forward(self, feature, shared_idx=None, train=False):
        feature = self.EdgeConv_0(self.ConvLayer_0(feature), idx=shared_idx,
                                  train=train)
        feature = self.EdgeConv_1(self.ConvLayer_1(feature), idx=shared_idx,
                                  train=train)
        return torch.relu(_head(self.Dense_0, self.SharedMLP_0(feature)))[..., 0]


def expand_pos(pos: torch.Tensor, edge: torch.Tensor, r: int) -> torch.Tensor:
    """pos [B, N, 3] + edge [B, N, 3r] -> [B, N*r, 3]; slot i*r + j is copy
    j of input point i."""
    b, n, _ = pos.shape
    return pos.repeat_interleave(r, dim=1) + edge.reshape(b, n * r, 3)


def expand_pos_with_masking(pos: torch.Tensor, edge: torch.Tensor,
                            mask: torch.Tensor, r: int, epsilon: float = 0.01
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hard-masked expansion: a point whose mask is <= epsilon keeps only
    copy 0 (its offsets are zeroed); copy 0 of every point is always kept.
    Returns (expanded [B, N*r, 3], padded [B, N*r, 3] with pruned copies at
    the sentinel, valid [B, N*r])."""
    b, n, _ = pos.shape
    gate = (mask > epsilon)[..., None]                         # [B, N, 1]
    expanded = expand_pos(pos, edge * gate.to(edge.dtype), r)
    hard = gate.expand(b, n, r).clone()
    hard[:, :, 0] = True
    valid = hard.reshape(b, n * r)
    padded = torch.where(valid[..., None], expanded, PAD_SENTINEL)
    return expanded, padded, valid


class SRNet(nn.Module):
    """Masked upsampling generator (serving at ``train=False``, training at
    ``train=True``).

    ``compute_dtype`` None keeps f32 everywhere; ``torch.bfloat16`` runs the
    inner convs, gathers and EdgeConvs in bf16 (f32 parameters; the offset
    and mask heads and the position expansion stay f32). ``graph_mode``
    "dynamic" rebuilds the kNN graph in every layer (7 graphs per forward);
    "static" builds one k=20 graph from the input graph source (pos when
    in_feats > 3, else the input feature) and every layer reuses it.
    ``fused_train`` trains every EdgeConv and IDGCN layer through the fused
    kernels and their backward (the JAX package's
    ``TPUGAN_FUSED_EDGECONV_TRAIN=1``; the port reads no environment
    variable); serving always takes them.

    Weights are drawn on the CPU from ``generator`` (seeded 0 when None);
    ``device`` None means the CUDA card, and raises without one.
    """

    epsilon = 0.01   # keep threshold of the raw mask

    def __init__(self, in_feats: int, node_emb_dim: int = 128,
                 upsample_ratio: int = 8, feature_extractor_depth: int = 3,
                 compute_dtype: Optional[torch.dtype] = None,
                 graph_mode: str = "dynamic", fused_train: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if graph_mode not in ("dynamic", "static"):
            raise ValueError(f"graph_mode {graph_mode!r}")
        if compute_dtype == torch.float32:
            compute_dtype = None
        self.in_feats, self.upsample_ratio = in_feats, upsample_ratio
        self.graph_mode = graph_mode
        self.compute_dtype = compute_dtype
        kw = dict(dtype=compute_dtype, fused_train=fused_train,
                  generator=seeded(generator), device=resolve_device(device))
        self.feature_extractor = GCNFeatureExtractor(
            in_feats, feature_extractor_depth, node_emb_dim, **kw)
        enc = (feature_extractor_depth - 1) * node_emb_dim
        self.upsampling_block = UpsamplingModule(enc, upsample_ratio, **kw)
        self.filter_block = BinaryMaskingModule(enc, **kw)

    def _encode(self, feature, pos, train):
        graph_pos = pos if self.in_feats > 3 else None
        shared_idx = None
        if self.graph_mode == "static":
            src = graph_pos if graph_pos is not None else feature
            _, shared_idx = graph_knn(src, k=20)
        encoding = self.feature_extractor(feature, pos=graph_pos,
                                          shared_idx=shared_idx, train=train)
        return encoding, shared_idx

    def heads(self, feature: torch.Tensor, pos: torch.Tensor,
              train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw (edge [B, N, 3r], mask [B, N]) heads, used by the rollout.
        Autograd records them only at ``train=True``."""
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            encoding, shared_idx = self._encode(feature, pos, train)
            return (self.upsampling_block(encoding, shared_idx=shared_idx,
                                          train=train),
                    self.filter_block(encoding, shared_idx=shared_idx,
                                      train=train))

    def forward(self, feature: torch.Tensor, pos: torch.Tensor,
                train: bool = False):
        """feature [B, N, in_feats], pos [B, N, 3] -> (expanded [B, N*r, 3],
        mask [B, N], padded [B, N*r, 3], valid [B, N*r])."""
        edge, mask = self.heads(feature, pos, train)
        expanded, padded, valid = expand_pos_with_masking(
            pos, edge, mask, self.upsample_ratio, self.epsilon)
        return expanded, mask, padded, valid


@dataclasses.dataclass
class RolloutMaskState:
    """Ring of the last ``history`` clamped masks (the rollout's 25-frame
    mask average), with a ring of which rows were real points when each
    mask was written, so a row's mean runs over only the frames in which it
    existed (ragged sequences pad frames to one bucket; for uniform ones
    this equals the plain mean over the frames seen). ``ptr`` is a host
    integer: advancing the ring never waits for the device."""

    buffer: torch.Tensor         # [H, B, N] clamped masks, 0 on padding rows
    valid_buffer: torch.Tensor   # [H, B, N] 1 where the row was a real point
    ptr: int = 0                 # next slot to write

    @classmethod
    def create(cls, batch: int, n: int, history: int = 25,
               device=None) -> "RolloutMaskState":
        device = resolve_device(device)
        zeros = lambda: torch.zeros((history, batch, n), device=device)
        return cls(zeros(), zeros())


def rollout_mask_update(state: RolloutMaskState, mask: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, RolloutMaskState]:
    """Clamp the mask (< 0.6 -> 0, > 0.6 -> 0.6), push it into the ring and
    return (per-row mean over the frames in which the row was real, state).
    ``valid`` [B, N] marks this frame's real rows (None: all). The ring is
    updated in place (one [B, N] row per frame, no copy of the ring)."""
    h = state.buffer.shape[0]
    clamped = torch.where(mask < 0.6, 0.0,
                          torch.where(mask > 0.6, 0.6, mask))
    v = (torch.ones_like(clamped) if valid is None
         else valid.to(clamped.dtype))
    state.buffer[state.ptr] = clamped * v
    state.valid_buffer[state.ptr] = v
    state.ptr = (state.ptr + 1) % h
    mean = state.buffer.sum(0) / state.valid_buffer.sum(0).clamp_min(1.0)
    return mean, state
