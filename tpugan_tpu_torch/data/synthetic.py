"""Synthetic data (``tpugan_tpu/data/synthetic.py``): SPH-like fluid
sequences, particle blobs advected through a smooth swirl under gravity
with box bounce, written in the reference schema ``case{i}/data_{t}.npz``
with ``pos [N, 3] f32`` and ``vel [N, 3] f32``; and MSR-Action3D-schema
action videos. The same seed gives the JAX package's files byte for
byte."""

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


def make_synthetic_action_dataset(root: str, num_videos: int = 4,
                                  frames: int = 12, points: int = 1500,
                                  seed: int = 0, num_classes: int = 3) -> str:
    """Write an MSR-Action3D-schema directory: ``a{label}_s{subject}_e{ex}_
    sdepth.npz`` files, each an object array ``point_clouds`` of [points, 3]
    f64 frames in depth-camera units. Subjects alternate between the train
    (<= 5) and test (> 5) splits (1, 6, 2, 7, ...), so a few videos reach
    both.

    Every class is the same blob; only its dynamics differ, and they are
    non-rigid (a label's breathing axis, rate and amplitude, and a rotation
    at a label's rate about a label's axis) so they survive the test split's
    per-frame centring. A label-dependent rigid sway and drift, a per-video
    random phase and per-point noise come on top."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for v in range(num_videos):
        label = (v % num_classes) + 1
        s = (v // num_classes) % 10
        subject = s // 2 + 1 + (5 if s % 2 else 0)
        body = _blob(rng, points, [0, 0, 0], 1.0) * np.array([60, 120, 40])
        axis = label % 3
        freq = 0.18 + 0.11 * (label % 5)
        amp = 22.0 + 9.0 * (label % 4)
        drift = 2.0 + 2.5 * ((label // 3) % 3)
        phase = rng.uniform(0, 2 * np.pi)
        b_axis = (label + 1) % 3                 # breathing axis
        b_freq = 0.25 + 0.17 * ((label * 2) % 5)
        b_amp = 0.22 + 0.08 * (label % 3)        # relative stretch
        r_axis = (label * 2) % 3                 # rotation axis
        r_rate = (0.05 + 0.04 * (label % 4)) * (1 if label % 2 else -1)
        b_phase = rng.uniform(0, 2 * np.pi)
        arr = np.empty(frames, dtype=object)
        for t in range(frames):
            stretch = np.ones(3, np.float64)
            stretch[b_axis] += b_amp * np.sin(b_freq * t + b_phase)
            th = r_rate * t
            i, j = (r_axis + 1) % 3, (r_axis + 2) % 3
            rot = np.eye(3)
            rot[i, i] = rot[j, j] = np.cos(th)
            rot[i, j], rot[j, i] = -np.sin(th), np.sin(th)
            deformed = (body * stretch) @ rot.T
            sway = np.zeros(3, np.float32)
            sway[axis] = amp * np.sin(freq * t + phase)
            sway[1] += drift * t
            frame = deformed + sway + rng.standard_normal((points, 3)) * 2
            frame = frame + np.array([0, 0, 800], np.float32)
            arr[t] = frame.astype(np.float64)
        ex = 1 + (v // num_classes) // 10        # unique past 10 subjects
        np.savez(os.path.join(
            root, f"a{label:02d}_s{subject:02d}_e{ex:02d}_sdepth.npz"),
            point_clouds=arr)
    return root
