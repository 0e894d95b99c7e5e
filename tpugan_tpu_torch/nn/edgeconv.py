"""EdgeConv and Inception-DenseGCN layers (``tpugan_tpu/nn/edgeconv.py``).

At ``train=False`` (serving) every EdgeConv runs through the fused kernel
(``ops/kernels/edgeconv.py``), as every generator EdgeConv does in the JAX
package there: the neighbour table is gathered neighbour-major,
``[B, K, N, C]``, and the kernel applies the node / edge affines, the
optional SharedMLP and the aggregation without writing any per-neighbour
intermediate.

At ``train=True`` the layers take the grouped plain formulation with
autograd (a point-major ``[B, N, K, C]`` table, the affines on it, ``amax``
or ``sum``), the path the JAX package runs in training by default, unless
the model asks for the fused path (``fused_train``, the JAX package's
``TPUGAN_FUSED_EDGECONV_TRAIN=1``): then training gathers neighbour-major
too, and the kernel's autograd Function carries the gradient back through
its backward kernel and the gather.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.nn.layers import (ConvLayer, SharedMLP, leaky_relu_02,
                                        seeded)
from tpugan_tpu_torch.ops.kernels.edgeconv import edgeconv_fused
from tpugan_tpu_torch.ops.neighbors import gather, graph_knn, group


def fused_enabled(train: bool, fused_train: bool) -> bool:
    """Serving always takes the fused kernel, training only when the model
    asks (``tpugan_tpu/nn/edgeconv.py : _fused_enabled``)."""
    return (not train) or fused_train


def gather_neighbor_major(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat [B, N, C], idx [B, N, K] -> [B, K, N, C] (plane j = neighbour j
    of every point); only the index tensor is transposed."""
    b, n, k = idx.shape
    idx_t = idx.transpose(1, 2).reshape(b, k * n)
    return gather(feat, idx_t).reshape(b, k, n, feat.shape[-1])


class EdgeConv(nn.Module):
    """Dynamic-graph edge convolution: k (dilated) nearest neighbours by
    ``pos`` when given, else by feature distance; node and edge affines,
    a SharedMLP (``mlp_layer``) or a linear head, and an aggregate.

    ``mlp_layer=False`` aggregates first and applies the head once, which is
    exact only for sum / mean (the linear head commutes with them); the
    generator uses it with sum, and the fused kernel needs it that way.
    ``fused_train``: see :func:`fused_enabled`.
    """

    def __init__(self, in_features: int, out_features: int, k: int = 9,
                 dilation: int = 1, mlp_layer: bool = True,
                 aggregate: str = "max", dtype: Optional[torch.dtype] = None,
                 fused_train: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if not mlp_layer and aggregate not in ("sum", "mean"):
            raise ValueError("EdgeConv without the MLP folds before its linear "
                             "head, which is exact only for sum or mean")
        generator, device = seeded(generator), resolve_device(device)
        half = out_features // 2
        self.k, self.dilation = k, dilation
        self.mlp_layer, self.aggregate, self.dtype = mlp_layer, aggregate, dtype
        self.fused_train = fused_train
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.ConvLayer_0 = ConvLayer(in_features, half, act=leaky_relu_02, **kw)
        self.ConvLayer_1 = ConvLayer(in_features, half, act=leaky_relu_02, **kw)
        if mlp_layer:
            self.SharedMLP_0 = SharedMLP(half, [half, out_features], **kw)
        else:
            self.ConvLayer_2 = ConvLayer(half, out_features, **kw)

    def forward(self, feat: torch.Tensor, pos: Optional[torch.Tensor] = None,
                idx: Optional[torch.Tensor] = None,
                neighbor_t: Optional[torch.Tensor] = None,
                train: bool = False,
                neighbor: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feat [B, N, C] -> [B, N, out]. ``idx`` [B, N, >=k] is a kNN list
        built elsewhere over the same graph source; ``neighbor_t``
        [B, >=k, N, C] a neighbour-major table gathered elsewhere (the fused
        path), ``neighbor`` [B, N, >=k, C] a point-major one (the grouped
        path; given it, the layer takes that path, as the JAX layer does)."""
        if self.dtype is not None:
            feat = feat.to(self.dtype)
        if neighbor is not None or not fused_enabled(train, self.fused_train):
            return self._grouped(feat, pos, idx, neighbor)
        if neighbor_t is None:
            if idx is None:
                _, idx = graph_knn(pos if pos is not None else feat, k=self.k)
            neighbor_t = gather_neighbor_major(
                feat, idx[:, :, :self.k:self.dilation])
        else:
            neighbor_t = neighbor_t[:, :self.k:self.dilation]
        w = lambda conv: conv.Dense_0.weight.t()       # flax layout [in, out]
        if self.mlp_layer:
            w1 = w(self.SharedMLP_0.ConvLayer_0)
            w2 = w(self.SharedMLP_0.ConvLayer_1)
        else:
            w1 = w2 = None
        y = edgeconv_fused(neighbor_t, feat, w(self.ConvLayer_0),
                           w(self.ConvLayer_1), w1, w2,
                           aggregate=self.aggregate,
                           compute_dtype=feat.dtype)
        return y if self.mlp_layer else self.ConvLayer_2(y)

    def _grouped(self, feat, pos, idx, neighbor):
        """The plain grouped formulation (differentiable)."""
        if neighbor is None:
            if idx is None:
                _, idx = graph_knn(pos if pos is not None else feat, k=self.k)
            neighbor = group(feat, idx[:, :, :self.k:self.dilation])
        else:
            neighbor = neighbor[:, :, :self.k:self.dilation]
        edge = neighbor - feat[:, :, None, :]
        y = self.ConvLayer_0(neighbor) + self.ConvLayer_1(edge)
        if self.mlp_layer:
            y = self.SharedMLP_0(y)
            if self.aggregate == "max":
                return y.amax(dim=2)
            if self.aggregate == "min":
                return y.amin(dim=2)
            return y.sum(2) if self.aggregate == "sum" else y.mean(2)
        y = y.sum(2) if self.aggregate == "sum" else y.mean(2)
        return self.ConvLayer_2(y)


class IDGCNLayer(nn.Module):
    """Inception-DenseGCN layer: bottleneck to C/4, three branches (local
    max over the 9 nearest, EdgeConv d=1, EdgeConv d=2) sharing one k=20
    list, concat, decode, residual skip. ``fused_train`` chooses the
    branches' path as :class:`EdgeConv`'s does (and the table's layout)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None,
                 fused_train: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.fused_train = fused_train
        c4 = in_features // 4
        self.ConvLayer_0 = ConvLayer(in_features, c4, **kw)       # bottleneck
        self.EdgeConv_0 = EdgeConv(c4, c4, k=20, dilation=1,
                                   fused_train=fused_train, **kw)
        self.EdgeConv_1 = EdgeConv(c4, c4, k=20, dilation=2,
                                   fused_train=fused_train, **kw)
        self.ConvLayer_1 = ConvLayer(3 * c4, out_features, act=leaky_relu_02,
                                     **kw)                        # decode
        self.ConvLayer_2 = ConvLayer(in_features, out_features, **kw)  # skip

    def forward(self, feat: torch.Tensor,
                shared_idx: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        x = self.ConvLayer_0(feat)                                # [B, N, C/4]
        idx20 = shared_idx if shared_idx is not None else graph_knn(x, 20)[1]
        if fused_enabled(train, self.fused_train):
            nbr_t = gather_neighbor_major(x, idx20)               # [B, 20, N, C/4]
            local_max = nbr_t[:, :9].amax(dim=1)
            kw = dict(neighbor_t=nbr_t)
        else:
            nbr = group(x, idx20)                                 # [B, N, 20, C/4]
            local_max = nbr[:, :, :9].amax(dim=2)
            kw = dict(neighbor=nbr)
        y = torch.cat([local_max, self.EdgeConv_0(x, train=train, **kw),
                       self.EdgeConv_1(x, train=train, **kw)], dim=-1)
        return self.ConvLayer_1(y) + self.ConvLayer_2(feat)
