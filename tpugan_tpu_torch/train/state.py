"""Optimiser and per-network train state (``tpugan_tpu/train/state.py``).

:class:`Adam` is ``optax.adam(exponential_decay(lr, decay_steps, rate,
staircase=True))`` step for step: its state is optax's chain, Adam's
``(count, mu, nu)`` and the schedule's own ``count``. An update is

    mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2,
    c = count + 1,  mu_hat = mu / (1 - b1^c),  nu_hat = nu / (1 - b2^c),
    p -= lr * decay^floor(sched_count / decay_steps)
         * mu_hat / (sqrt(nu_hat) + 1e-8),

and a parameter without a gradient takes g = 0, as optax sees a zero
gradient for a parameter the loss does not reach.

:func:`init_fluid_state` builds a fresh trainer (``tpugan_tpu/train/step.py
: init_fluid_state``): the three networks from a seed and zero Adam states,
the generator at ``cfg.lr`` and the critics at ``cfg.dis_lr_factor *
cfg.lr``, all with the staircase decay.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn


class Adam:
    """Adam with staircase exponential learning-rate decay over named
    parameters (the torch Adam + StepLR of the reference)."""

    def __init__(self, params: Dict[str, nn.Parameter], lr: float,
                 decay_steps: int, decay_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(params)
        self.lr, self.decay_steps, self.decay_rate = lr, decay_steps, decay_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0            # Adam's count (optax state '0')
        self.sched_count = 0      # the schedule's count (optax state '1')
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def learning_rate(self) -> float:
        return self.lr * self.decay_rate ** (self.sched_count // self.decay_steps)

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One update from ``grads`` (name -> gradient or None)."""
        c = self.count + 1
        step = self.learning_rate()
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** c
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** c
        for k, p in self.params.items():
            g = grads.get(k)
            if g is None:
                g = torch.zeros_like(p)
            mu = self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            nu = self.nu[k].mul_(self.b2).add_((1 - self.b2) * (g * g))
            upd = (mu / bc1.to(p.device)) / (torch.sqrt(nu / bc2.to(p.device))
                                            + self.eps)
            p.sub_(step * upd)
        self.count = c
        self.sched_count += 1


@dataclasses.dataclass
class NetState:
    """One network with its optimiser: params and buffers (BatchNorm
    running moments, spectral-norm u / sigma) live in ``module``."""

    module: nn.Module
    opt: Adam

    @classmethod
    def create(cls, module: nn.Module, lr: float, decay_steps: int,
               decay_rate: float) -> "NetState":
        return cls(module, Adam(dict(module.named_parameters()), lr,
                                decay_steps, decay_rate))

    def grads(self, loss: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        """Gradients of ``loss`` for the module's parameters; unreached
        ones are None."""
        got = torch.autograd.grad(loss, list(self.opt.params.values()),
                                  allow_unused=True)
        return dict(zip(self.opt.params, got))


@dataclasses.dataclass
class GanTrainState:
    """The three networks of the fluid GAN and the iteration count."""

    n_iter: int
    sr: NetState
    tempo: NetState
    spatial: NetState


def init_fluid_state(cfg, seed: int = 0, device=None,
                     fused_train: bool = False) -> GanTrainState:
    """A fresh fluid trainer of ``cfg`` (a ``FluidTrainConfig``): SRNet of
    its widths (``fused_train``: see :class:`SRNet`), the temporal and the
    spatial critic, weights drawn from ``seed`` on the CPU, zero Adam
    states, ``n_iter`` 0, on ``device`` (the card when None)."""
    from tpugan_tpu_torch import resolve_device
    from tpugan_tpu_torch.models.discriminator import (FluidSpatialDis,
                                                       FluidTempoDis)
    from tpugan_tpu_torch.models.generator import SRNet

    device = resolve_device(device)
    gens = [torch.Generator().manual_seed(seed + i) for i in range(3)]
    nets = {
        "sr": SRNet(in_feats=cfg.in_node_feats, node_emb_dim=cfg.node_embedding,
                    upsample_ratio=cfg.upsample_ratio, fused_train=fused_train,
                    generator=gens[0], device=device),
        "tempo": FluidTempoDis(3, generator=gens[1], device=device),
        "spatial": FluidSpatialDis(generator=gens[2], device=device)}
    d_lr = cfg.dis_lr_factor * cfg.lr
    return GanTrainState(n_iter=0, **{
        name: NetState.create(net, cfg.lr if name == "sr" else d_lr,
                              cfg.lr_decay_steps, cfg.lr_decay_rate)
        for name, net in nets.items()})
