"""Pointwise layers of the generator (subset of ``tpugan_tpu/nn/layers.py``).

Bias quirk kept from the reference: the generator's norm-free convs carry
no bias (gcn_lib enables the conv bias exactly when a norm follows). The
biased heads are plain ``nn.Linear``.

Module and parameter names follow the flax scopes (``ConvLayer_0``,
``Dense_0``, ...), so a flax path ``a/b/Dense_0/kernel`` is the torch key
``a.b.Dense_0.weight`` (transposed): see ``tpugan_tpu_torch/checkpoint.py``.

Compute dtype follows flax ``nn.Dense``: with ``dtype`` set, input and
weight are cast to it and the output has it; with ``dtype=None`` the input
is promoted to the f32 parameter dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_tpu_torch import resolve_device


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or a CPU generator seeded with 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def dense(in_features: int, out_features: int, bias: bool,
          generator: torch.Generator, device: torch.device,
          scale: float = 1.0, bias_init: float = 0.0) -> nn.Linear:
    """``nn.Linear`` initialised like flax's ``nn.Dense``: truncated-normal
    variance scaling over fan-in (``scale=1`` is LeCun normal), drawn on the
    CPU from ``generator`` so a seed gives the same weights on every device.
    """
    w = torch.empty(out_features, in_features)
    # flax divides by the std of a unit normal truncated at +-2
    std = math.sqrt(scale / in_features) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    lin = nn.Linear(in_features, out_features, bias=bias, device="meta")
    lin.weight = nn.Parameter(w.to(device))
    if bias:
        lin.bias = nn.Parameter(
            torch.full((out_features,), bias_init, device=device))
    return lin


def promoted_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    """flax promotion: ``dtype`` when set, else x promoted with f32 params."""
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               torch.float32)


class ConvLayer(nn.Module):
    """One pointwise bias-free Dense plus an optional activation (the
    generator's norm-free ``conv_bn_layer``)."""

    def __init__(self, in_features: int, features: int,
                 act: Optional[Callable] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.act = act
        self.dtype = dtype
        self.Dense_0 = dense(in_features, features, False, seeded(generator),
                             resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = promoted_dtype(x, self.dtype)
        y = F.linear(x.to(cdt), self.Dense_0.weight.to(cdt))
        return self.act(y) if self.act is not None else y


class SharedMLP(nn.Module):
    """Stack of pointwise ConvLayers with leaky ReLU (0.2); ``features``
    lists the output widths."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        for i, f in enumerate(features):
            self.add_module(f"ConvLayer_{i}", ConvLayer(
                in_features, f, act=leaky_relu_02, dtype=dtype,
                generator=generator, device=device))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x
