"""Host-side numpy sampling of the input pipeline: the port's own copy of the
parts of ``tpugan_tpu/data/sampling.py`` that the dataset and the eval path
use (numpy farthest point sampling, the kd-tree patch with its FPS
downsample, bucket padding, radius counts and free-surface particles).

The JAX package takes its native C++ FPS and patch search when that library
is built; the port has no native code. Its FPS is the numpy loop, which
picks the same indices as the native one (f32 distances, first index of the
maximum), and its patch is the scipy kd-tree query.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

BASE_RADIUS = 0.025   # the reference's particle radius


def farthest_point_sampling(pts: np.ndarray, k: int,
                            initial_idx: Optional[int] = None,
                            rng: Optional[np.random.Generator] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy farthest point sampling: (indices [k] int64, running minimum
    squared distance [N]). The first index is ``initial_idx``, or drawn from
    ``rng`` when None."""
    if pts.ndim != 2:
        raise ValueError(f"farthest_point_sampling: pts of shape {pts.shape}")
    n = pts.shape[0]
    indices = np.zeros((k,), dtype=np.int64)
    if initial_idx is None:
        rng = rng or np.random.default_rng()
        indices[0] = rng.integers(n)
    else:
        indices[0] = initial_idx
    diff = pts - pts[indices[0]]
    min_d = np.einsum("nd,nd->n", diff, diff)
    for i in range(1, k):
        indices[i] = int(np.argmax(min_d))
        diff = pts - pts[indices[i]]
        d = np.einsum("nd,nd->n", diff, diff)
        np.minimum(min_d, d, out=min_d)
    return indices, min_d


def normalize_point_cloud(pos: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.float32]:
    """Centroid shift; the furthest-distance scale is pinned to 1, as in
    the reference."""
    centroid = np.mean(pos, axis=0, keepdims=True)
    furthest_distance = np.float32(1.0)
    return (pos - centroid) / furthest_distance, centroid, furthest_distance


def sample_patch_with_fps(input_pos: np.ndarray,
                          sample_num: Optional[int] = None,
                          fps_ratio: float = 0.125,
                          rng: Optional[np.random.Generator] = None,
                          fps: bool = True
                          ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                     Optional[np.ndarray]]:
    """The kd-tree patch of ``sample_num`` nearest points around a random
    seed point, and its FPS downsample to ``fps_ratio`` of the patch.
    Returns ({patch_pos, ds_pos}, patch_idx, fps_idx); ``fps=False`` skips
    the downsample (``ds_pos`` and ``fps_idx`` None)."""
    rng = rng or np.random.default_rng()
    total = input_pos.shape[0]
    if sample_num is None:
        patch_num = 9216 if total > 10000 else (total // 1024) * 1024
    else:
        patch_num = sample_num if total > sample_num else 4096
    patch_num = min(patch_num, total)
    seed = int(rng.integers(total))
    _, patch_idx = cKDTree(input_pos).query(input_pos[seed], patch_num)
    patch_pos = input_pos[patch_idx]
    if not fps:
        return {"patch_pos": patch_pos, "ds_pos": None}, patch_idx, None
    fps_idx, _ = farthest_point_sampling(patch_pos, int(fps_ratio * patch_num),
                                         rng=rng)
    return ({"patch_pos": patch_pos, "ds_pos": patch_pos[fps_idx]},
            patch_idx, fps_idx)


def dump_pointcloud_visualization(pos: np.ndarray, filename: str) -> None:
    """Headless scatter render of a cloud to PNG through matplotlib, as the
    JAX package's does (reference train_utils.py:224-238 used Open3D's
    offscreen capture); where matplotlib does not import, the cloud is
    saved as ``filename + ".npy"`` instead."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.save(filename + ".npy", pos)
        return
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pos[:, 0], pos[:, 2], pos[:, 1], s=0.5)
    ax.set_axis_off()
    fig.savefig(filename, dpi=120, bbox_inches="tight")
    plt.close(fig)


def pad_with_appropriate_size(pos: np.ndarray, bucket: int = 1024,
                              sentinel: float = 999.0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a variable-size cloud with ``sentinel`` rows up to the next
    multiple of ``bucket`` (at least one bucket): (padded, valid mask)."""
    n = pos.shape[0]
    target = max(bucket, ((n + bucket - 1) // bucket) * bucket)
    padded = np.full((target, pos.shape[1]), sentinel, pos.dtype)
    padded[:n] = pos
    valid = np.zeros(target, bool)
    valid[:n] = True
    return padded, valid


def fixed_radius_neighbor_num(pos: np.ndarray, radius: float) -> np.ndarray:
    """Per-point neighbour counts within ``radius``, the point included."""
    tree = cKDTree(pos)
    return np.asarray(tree.query_ball_point(pos, radius, return_length=True))


def get_free_surface_particles(pos: np.ndarray, radius: float) -> np.ndarray:
    """Particles whose neighbour count falls below 85% of the dense bulk's
    (the mean count between the 95th and the 99th percentile)."""
    nbr = fixed_radius_neighbor_num(pos, radius)
    sorted_nbr = np.sort(nbr)
    n = pos.shape[0]
    threshold = np.mean(sorted_nbr[int(n * 0.95): n - int(n * 0.01)])
    return pos[nbr < 0.85 * threshold]
