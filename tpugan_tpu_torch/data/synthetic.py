"""Synthetic SPH-like fluid sequences (``tpugan_tpu/data/synthetic.py``):
particle blobs advected through a smooth swirl under gravity with box
bounce, written in the reference schema ``case{i}/data_{t}.npz`` with
``pos [N, 3] f32`` and ``vel [N, 3] f32``. The same seed gives the JAX
package's fixtures exactly."""

from __future__ import annotations

import os

import numpy as np

from tpugan_tpu_torch import DT


def _blob(rng: np.random.Generator, n: int, center, radius: float) -> np.ndarray:
    """Roughly uniform ball of n particles."""
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = radius * rng.uniform(0, 1, (n, 1)) ** (1.0 / 3.0)
    return (np.asarray(center) + v * r).astype(np.float32)


def synthetic_fluid_sequence(seed: int = 0, num_particles: int = 12000,
                             num_frames: int = 24, box: float = 1.0):
    """Yield (pos, vel) frames of a falling, swirling particle blob."""
    rng = np.random.default_rng(seed)
    n_blobs = int(rng.integers(1, 4))
    # blob sizes sum exactly to num_particles
    counts = [num_particles // n_blobs] * n_blobs
    counts[-1] += num_particles - sum(counts)
    parts = []
    for nb in counts:
        c = rng.uniform(-0.4 * box, 0.4 * box, 3)
        c[1] = rng.uniform(0.0, 0.6 * box)
        parts.append(_blob(rng, nb, c, rng.uniform(0.15, 0.3) * box))
    pos = np.concatenate(parts)[:num_particles]
    vel = np.tile(rng.uniform(-0.5, 0.5, (1, 3)).astype(np.float32),
                  (pos.shape[0], 1))

    g = np.array([0.0, -9.81, 0.0], np.float32)
    for _ in range(num_frames):
        yield pos.copy(), vel.copy()
        swirl = 0.8 * np.stack(
            [np.sin(3 * pos[:, 1]), np.zeros(pos.shape[0]),
             np.cos(3 * pos[:, 0])], axis=1).astype(np.float32)
        vel = vel + DT * (g + swirl)
        pos = pos + DT * vel
        for d in range(3):
            lo, hi = (-box, box) if d != 1 else (-0.8 * box, 1.5 * box)
            under, over = pos[:, d] < lo, pos[:, d] > hi
            pos[under, d] = 2 * lo - pos[under, d]
            pos[over, d] = 2 * hi - pos[over, d]
            vel[under | over, d] *= -0.5


def make_synthetic_fluid_dataset(root: str, case_num: int = 2,
                                 case_steps: int = 12,
                                 num_particles: int = 12000,
                                 case_prefix: str = "data",
                                 case_to_start: int = 1, seed: int = 0) -> str:
    """Write a reference-schema dataset directory of synthetic sequences."""
    os.makedirs(root, exist_ok=True)
    for c in range(case_num):
        case_dir = os.path.join(root, f"case{c + case_to_start}")
        os.makedirs(case_dir, exist_ok=True)
        frames = synthetic_fluid_sequence(seed=seed + c,
                                          num_particles=num_particles,
                                          num_frames=case_steps)
        for t, (pos, vel) in enumerate(frames):
            np.savez(os.path.join(case_dir, f"{case_prefix}_{t}.npz"),
                     pos=pos, vel=vel)
    return root
