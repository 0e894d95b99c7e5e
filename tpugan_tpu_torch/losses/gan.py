"""LSGAN objectives with smoothed, occasionally flipped labels
(``tpugan_tpu/losses/gan.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def lsgan_labels(generator: Optional[torch.Generator] = None,
                 flip_p: float = 0.03) -> Tuple[float, float]:
    """(valid ~ U(0.8, 1.2), invalid ~ U(0, 0.2)), swapped with p=flip_p."""
    u = torch.rand(3, generator=generator, dtype=torch.float64).tolist()
    valid, invalid = 0.8 + 0.4 * u[0], 0.2 * u[1]
    return (invalid, valid) if u[2] < flip_p else (valid, invalid)


def lsgan_generator_loss(fake_score: torch.Tensor, target) -> torch.Tensor:
    """0.5 (D(fake) - target)^2, batch mean."""
    return (0.5 * (fake_score - target) ** 2).mean()


def lsgan_discriminator_loss(true_score: torch.Tensor,
                             fake_score: torch.Tensor, valid,
                             invalid) -> torch.Tensor:
    """0.5 [(D(real) - valid)^2 + (D(fake) - invalid)^2], batch mean."""
    return (0.5 * ((true_score - valid) ** 2
                   + (fake_score - invalid) ** 2)).mean()
