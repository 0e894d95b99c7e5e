"""Pointwise layers (``tpugan_tpu/nn/layers.py``): Dense with flax
initialisation, a BatchNorm and a SpectralNorm with flax semantics, the
ConvLayer, the SharedMLP (with its fused pooled path) and the dense MLP
head.

Bias quirk kept from the reference: the generator's norm-free convs carry
no bias (gcn_lib enables the conv bias exactly when a norm follows); the
discriminator's set-abstraction convs pass ``use_bias = not bn``.

Module, parameter and buffer names follow the flax scopes (``ConvLayer_0``,
``Dense_0``, ``BatchNorm_0``, ``SpectralNorm_0``, ...), so a flax path
``a/b/Dense_0/kernel`` is the torch key ``a.b.Dense_0.weight``
(transposed), BatchNorm's ``scale`` / ``bias`` / ``mean`` / ``var`` keep
their names, and a spectral norm's ``.../SpectralNorm_0/Dense_0/kernel/u``
is the buffer ``...SpectralNorm_0.u``: see ``tpugan_tpu_torch/checkpoint.py``.

Grouped batch statistics (``stat_groups``, the JAX package's
``stat_groups`` / ``GroupedBatchNorm`` / ``ambient_batch_norm``): the
critics' stacked applies (``--fast_d``) run several calls of one module as
one call on their rows stacked along the leading axis. Inside
``with stat_groups(G):`` every ``BatchNorm`` in train mode treats that axis
as G equal blocks, each normalised with its own moments, and steps its
running averages once per block in block order: G sequential calls in one.

Cross-rank batch statistics (``cross_rank_stats``, the data-parallel
steps' twin of GSPMD's global-batch moments): inside the context every
train-mode ``BatchNorm`` sums its moments over this rank's rows (per stat
group) and all-reduces the sums with the autograd-aware all-reduce it is
given, so each rank normalises with the global batch's moments and the
backward carries the other ranks' terms, as SyncBatchNorm does. A fused
``SharedMLP.pooled`` in train mode hands the same sum to the pooled-MLP
kernel, which sums each layer's moment sums over the ranks between its
passes (the JAX package's kernel runs there too, on GSPMD's global
batch).

Compute dtype follows flax ``nn.Dense``: with ``dtype`` set, input and
weight are cast to it and the output has it; with ``dtype=None`` the input
is promoted to the f32 parameter dtype.

Activations are written as the JAX package writes them:
``where(x >= 0, x, slope * x)``, whose gradient at 0 is 1 (torch's
``leaky_relu`` gives the slope there, and EdgeConv's self-edge is exactly
0, so the choice shows in the generator's gradients).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.ops.kernels.pooled_mlp import (pooled_mlp_affine,
                                                     pooled_mlp_bn_train)


# The stat groups of every train-mode BatchNorm (1: the whole batch). Set
# around a stacked apply by ``stat_groups``; read by ``BatchNorm.forward``
# and checked by ``SharedMLP.pooled``.
_STAT_GROUPS = 1


@contextlib.contextmanager
def stat_groups(n: int):
    """Every train-mode ``BatchNorm`` called inside computes its moments
    over ``n`` equal blocks of the leading axis (restored on exit)."""
    global _STAT_GROUPS
    prev, _STAT_GROUPS = _STAT_GROUPS, int(n)
    try:
        yield
    finally:
        _STAT_GROUPS = prev


def current_stat_groups() -> int:
    """The stat groups in force (1 outside any ``stat_groups``)."""
    return _STAT_GROUPS


# (reduce, world) of the cross-rank batch statistics, or None: set around a
# data-parallel step by ``cross_rank_stats``; read by ``BatchNorm.forward``
# and handed to the kernel by ``SharedMLP.pooled``.
_STAT_REDUCE = None


@contextlib.contextmanager
def cross_rank_stats(reduce: Callable[[torch.Tensor], torch.Tensor],
                     world: int):
    """Every train-mode ``BatchNorm`` called inside pools its moment sums
    over ``world`` ranks of equal row counts through ``reduce`` (an
    autograd-aware sum over the ranks; restored on exit)."""
    global _STAT_REDUCE
    prev, _STAT_REDUCE = _STAT_REDUCE, (reduce, int(world))
    try:
        yield
    finally:
        _STAT_REDUCE = prev


def fusable_stats() -> bool:
    """True when a train-mode batch norm's moments are those of all the
    rows of its call, or of all the rows of every rank's call under
    ``cross_rank_stats``: no ``stat_groups`` with G > 1 (the JAX package's
    ``_fusable``). Only then may the pooled-MLP kernel compute them."""
    return _STAT_GROUPS == 1


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def leaky_relu_001(x: torch.Tensor) -> torch.Tensor:
    # torch F.leaky_relu / nn.LeakyReLU() default slope
    return torch.where(x >= 0, x, 0.01 * x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def act_slope(act: Callable) -> Optional[float]:
    """Leaky-ReLU slope of a supported activation (0 = ReLU), else None."""
    return {relu: 0.0, leaky_relu_001: 0.01, leaky_relu_02: 0.2}.get(act)


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


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (torch's BatchNorm differs on
    every point below). Train: batch moments in f32 over all other axes,
    the fast biased variance ``max(0, E[x^2] - E[x]^2)`` for both the
    normalisation and the running variance, and running averages
    ``ra = 0.99 ra + 0.01 batch``. Eval: the running moments. eps 1e-5.

    Under ``stat_groups(G)`` with G > 1, train mode takes the leading axis
    as G equal blocks (a ``ValueError`` when it does not divide): f32
    moments per block, each block normalised with its own, the running
    averages stepped once per block in block order (the JAX package's
    ``GroupedBatchNorm``). Under ``cross_rank_stats`` the moment sums of
    every block are all-reduced over the ranks first. The parameters and
    buffers are the same in every mode."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    @torch.no_grad()
    def update_stats(self, mu: torch.Tensor, var: torch.Tensor) -> None:
        """One running-average step from batch moments."""
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mu)
        self.var.copy_(m * self.var + (1 - m) * var)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        g = _STAT_GROUPS
        if train and (g > 1 or _STAT_REDUCE is not None):
            return self._grouped(x32, g)
        if train:
            dims = tuple(range(x32.dim() - 1))
            mu = x32.mean(dims)
            var = torch.clamp_min((x32 * x32).mean(dims) - mu * mu, 0.0)
            self.update_stats(mu.detach(), var.detach())
        else:
            mu, var = self.mean, self.var
        return (x32 - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias

    def _grouped(self, x32: torch.Tensor, g: int) -> torch.Tensor:
        if x32.shape[0] % g:
            raise ValueError(f"leading axis {x32.shape[0]} not divisible into "
                             f"{g} stat groups")
        xg = x32.reshape((g, x32.shape[0] // g) + x32.shape[1:])
        dims = tuple(range(1, xg.dim() - 1))
        if _STAT_REDUCE is None:
            mu = xg.mean(dims)                                    # [G, C]
            var = torch.clamp_min((xg * xg).mean(dims) - mu * mu, 0.0)
        else:
            reduce, world = _STAT_REDUCE
            rows = math.prod(xg.shape[1:-1]) * world
            sums = reduce(torch.stack([xg.sum(dims), (xg * xg).sum(dims)]))
            mu = sums[0] / rows
            var = torch.clamp_min(sums[1] / rows - mu * mu, 0.0)
        for i in range(g):                    # block order, as G calls
            self.update_stats(mu[i].detach(), var[i].detach())
        shape = (g,) + (1,) * len(dims) + (x32.shape[-1],)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xg - mu.reshape(shape)) * mul.reshape(shape) + self.bias
        return y.reshape(x32.shape)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """flax 0.12.3 ``nn.SpectralNorm`` of a Dense kernel (the bias is not
    normalised). On every call, train or eval, one power step from the
    stored ``u`` [1, out]: ``v = l2n(u W^T)``, ``u = l2n(v W)`` with W the
    kernel [in, out]; u and v carry no gradient; ``W / sigma`` with
    ``sigma = v W u^T``. ``u`` and ``sigma`` are stored only when
    ``update_stats`` (train)."""

    def __init__(self, out_features: int, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        u = torch.randn(1, out_features, generator=generator)
        self.register_buffer("u", u.to(device))
        self.register_buffer("sigma", torch.ones((), device=device))

    def forward(self, weight: torch.Tensor, update_stats: bool) -> torch.Tensor:
        """weight [out, in] (torch layout) -> the normalised weight."""
        w = weight.t()                                     # flax [in, out]
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.t())
            u = _l2_normalize(v @ w)
        sigma = (v @ w @ u.t())[0, 0]
        w_bar = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w_bar.t()


class ConvLayer(nn.Module):
    """One pointwise Dense, optionally spectral-normalised, then an optional
    batch norm and an optional activation (``conv_bn_layer``).
    ``use_bias=None`` takes the gcn_lib quirk: a bias exactly when a norm
    follows."""

    def __init__(self, in_features: int, features: int,
                 act: Optional[Callable] = None, norm: str = "none",
                 spectral_norm: bool = False, use_bias: Optional[bool] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if norm not in ("none", "batch"):
            raise ValueError(f"unsupported norm {norm!r}")
        generator, device = seeded(generator), resolve_device(device)
        self.act, self.norm, self.dtype = act, norm, dtype
        if use_bias is None:
            use_bias = norm == "batch"
        self.Dense_0 = dense(in_features, features, use_bias, generator, device)
        if spectral_norm:
            self.SpectralNorm_0 = SpectralNorm(features, generator, device)
        if norm == "batch":
            self.BatchNorm_0 = BatchNorm(features, device=device)

    def weight(self, train: bool) -> torch.Tensor:
        """The effective weight [out, in]; a spectral norm advances here."""
        w = self.Dense_0.weight
        if hasattr(self, "SpectralNorm_0"):
            w = self.SpectralNorm_0(w, update_stats=train)
        return w

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cdt = promoted_dtype(x, self.dtype)
        bias = self.Dense_0.bias
        y = F.linear(x.to(cdt), self.weight(train).to(cdt),
                     None if bias is None else bias.to(cdt))
        if self.norm == "batch":
            y = self.BatchNorm_0(y, train)
        return self.act(y) if self.act is not None else y


class SharedMLP(nn.Module):
    """Stack of pointwise ConvLayers, each with the optional norm and the
    activation ``act`` (the generator's leaky ReLU 0.2 by default);
    ``features`` lists the output widths."""

    def __init__(self, in_features: int, features: Sequence[int],
                 act: Callable = leaky_relu_02, norm: str = "none",
                 spectral_norm: bool = False, use_bias: Optional[bool] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        self.act, self.norm, self.dtype = act, norm, dtype
        for i, f in enumerate(features):
            self.add_module(f"ConvLayer_{i}", ConvLayer(
                in_features, f, act=act, norm=norm,
                spectral_norm=spectral_norm, use_bias=use_bias, dtype=dtype,
                generator=generator, device=device))
            in_features = f

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self.children():
            x = layer(x, train)
        return x

    def pooled(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The stack on a grouped table [B, M, ns, C], then the max over ns,
        as one fused op: the pooled-MLP kernels (``ops/kernels/pooled_mlp.py``)
        for a stack of f32 layers with a (leaky) ReLU, batch-normalised and
        bias-free, or norm-free with or without a Dense bias (the JAX
        package's ``_fused_pooled``); the max splits the gradient over ties
        as ``jnp.max`` does.

        Each spectral norm advances once per call. A norm-free stack is the
        affine form with a = 1 and b = the bias (or 0). In training the
        batch moments come from the kernel and each BatchNorm's running
        average takes one step from the 2-point probe ``[mu - s, mu + s]``
        (s = sqrt(max(var, 0))), whose moments are the batch's, as the JAX
        package's ``bn_update`` probe does.

        The kernel pools the moments of all rows of this call (under
        ``cross_rank_stats``, of every rank's call: it sums each layer's
        moment sums over the ranks through the context's sum), so it refuses
        to run under ``stat_groups`` with G > 1: a caller takes the plain
        stack there (the JAX package's ``_fusable``)."""
        if not fusable_stats():
            raise ValueError(f"the pooled-MLP kernel pools the moments of all "
                             f"rows of its call: not under stat_groups("
                             f"{_STAT_GROUPS})")
        layers = list(self.children())
        slope = act_slope(self.act)
        if self.dtype is not None or slope is None:
            raise ValueError("the pooled-MLP kernel takes f32 layers with a "
                             "(leaky) ReLU")
        if self.norm == "batch" and any(layer.Dense_0.bias is not None
                                        for layer in layers):
            raise ValueError("the pooled-MLP kernel takes a bias-free "
                             "batch-norm stack")
        ws = [layer.weight(train).t() for layer in layers]
        if self.norm == "none":
            ones = [torch.ones(w.shape[1], device=w.device) for w in ws]
            bs = [layer.Dense_0.bias if layer.Dense_0.bias is not None
                  else torch.zeros(w.shape[1], device=w.device)
                  for layer, w in zip(layers, ws)]
            return pooled_mlp_affine(x, ws, ones, bs, slope)
        bns = [layer.BatchNorm_0 for layer in layers]
        if train:
            reduce, world = _STAT_REDUCE or (None, 1)
            pooled, mus, vars_ = pooled_mlp_bn_train(
                x, ws, [bn.scale for bn in bns], [bn.bias for bn in bns], slope,
                reduce=reduce, world=world)
            for bn, mu, var in zip(bns, mus, vars_):
                s = torch.sqrt(torch.clamp_min(var, 0.0))
                probe = torch.stack([mu - s, mu + s])
                pm = probe.mean(0)
                bn.update_stats(pm, torch.clamp_min((probe * probe).mean(0)
                                                    - pm * pm, 0.0))
            return pooled
        a_s = [bn.scale * torch.rsqrt(torch.clamp_min(bn.var, 0.0) + bn.eps)
               for bn in bns]
        b_s = [bn.bias - bn.mean * a for bn, a in zip(bns, a_s)]
        return pooled_mlp_affine(x, ws, a_s, b_s, slope)


class MLP(nn.Module):
    """The plain dense MLP head (reference gcn_lib/nn.py:7-54):
    ``hidden_layers`` Dense layers, ``hidden_dim`` wide but the last
    (``out_features``), ``act`` after each but the last and, with
    ``activation_first``, before the first; with ``spectral_norm`` each
    Dense kernel spectral-normalised (one power step a call, its ``u``
    stored in train mode). Parameter names follow flax: ``Dense_l`` and
    ``SpectralNorm_l``."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_dim: int = 128, hidden_layers: int = 3,
                 act: Callable = relu, activation_first: bool = False,
                 spectral_norm: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        generator, device = seeded(generator), resolve_device(device)
        self.act, self.activation_first = act, activation_first
        self.hidden_layers, self.spectral_norm = hidden_layers, spectral_norm
        for l in range(hidden_layers):
            width = out_features if l == hidden_layers - 1 else hidden_dim
            self.add_module(f"Dense_{l}", dense(in_features, width, True,
                                                generator, device))
            if spectral_norm:
                self.add_module(f"SpectralNorm_{l}",
                                SpectralNorm(width, generator, device))
            in_features = width

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if self.activation_first:
            x = self.act(x)
        for l in range(self.hidden_layers):
            lin = getattr(self, f"Dense_{l}")
            w = lin.weight
            if self.spectral_norm:
                w = getattr(self, f"SpectralNorm_{l}")(w, update_stats=train)
            x = F.linear(x, w, lin.bias)
            if l < self.hidden_layers - 1:
                x = self.act(x)
        return x
