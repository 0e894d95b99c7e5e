"""Host-side sampling of the input pipeline: the port's own copy of
``tpugan_tpu/data/sampling.py`` (farthest point sampling, the nearest-point
patch with its FPS downsample, voxel downsampling with and without
features, the voxel-downsampled patch sampler, overlap filtering, bucket
padding, a cloud's bounds, radius counts and free-surface particles).

As the JAX package's loader does when its library is built, the loader's
two hot loops run in the port's native library (``data/native.py``):
:func:`farthest_point_sampling` and the patch search of
:func:`sample_patch_with_fps`. Their plain versions stay beside them, with
the library entry points' signatures, for the tests and the card's
comparisons (:data:`PLAIN` maps each entry point to its plain version),
and nothing on the loader's path calls them: :func:`fps_plain`, the numpy
loop of the JAX package's fallback, and :func:`knn_patch_plain`, its scipy
kd-tree query. The library computes squared distances in f32 as its
compiler contracts them (fused multiply-adds under ``-march=native``) and
orders the patch by them, index breaking ties; the kd-tree orders by f64
distances. So the two may order points whose distances lie within
rounding of each other differently (and take a different last point where
the patch's last and the next lie so), and FPS may take one of two
near-equal farthest points where the other takes the other.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from tpugan_tpu_torch.data import native

BASE_RADIUS = 0.025   # the reference's particle radius


def fps_plain(pts: np.ndarray, k: int, start: int = 0) -> np.ndarray:
    """Greedy farthest point sampling in numpy from ``start``: indices [k]
    int64, the JAX package's fallback loop."""
    indices = np.zeros((k,), dtype=np.int64)
    indices[0] = start
    diff = pts - pts[indices[0]]
    min_d = np.einsum("nd,nd->n", diff, diff)
    for i in range(1, k):
        indices[i] = int(np.argmax(min_d))
        diff = pts - pts[indices[i]]
        d = np.einsum("nd,nd->n", diff, diff)
        np.minimum(min_d, d, out=min_d)
    return indices


def farthest_point_sampling(pts: np.ndarray, k: int,
                            initial_idx: Optional[int] = None,
                            rng: Optional[np.random.Generator] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy farthest point sampling in the native library: (indices [k]
    int64, an empty array where the plain loop returns its running
    distances, which no caller reads). The first index is ``initial_idx``,
    or drawn from ``rng`` when None."""
    if pts.ndim != 2:
        raise ValueError(f"farthest_point_sampling: pts of shape {pts.shape}")
    if initial_idx is None:
        rng = rng or np.random.default_rng()
        start = int(rng.integers(pts.shape[0]))
    else:
        start = int(initial_idx)
    return native.fps(pts, k, start), np.empty(0, np.float32)


def normalize_point_cloud(pos: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.float32]:
    """Centroid shift; the furthest-distance scale is pinned to 1, as in
    the reference."""
    centroid = np.mean(pos, axis=0, keepdims=True)
    furthest_distance = np.float32(1.0)
    return (pos - centroid) / furthest_distance, centroid, furthest_distance


def knn_patch_plain(input_pos: np.ndarray, seed: int, k: int) -> np.ndarray:
    """The ``k`` points nearest to point ``seed`` by the scipy kd-tree,
    ascending by distance: indices int64 (the JAX package's fallback)."""
    return cKDTree(input_pos).query(input_pos[seed], k)[1]


# The plain version of each library entry point that the loader calls,
# with that entry point's signature.
PLAIN = {"fps": fps_plain, "knn_patch": knn_patch_plain}


def sample_patch_with_fps(input_pos: np.ndarray,
                          sample_num: Optional[int] = None,
                          fps_ratio: float = 0.125,
                          rng: Optional[np.random.Generator] = None,
                          fps: bool = True
                          ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                     Optional[np.ndarray]]:
    """The patch of ``sample_num`` nearest points around a random seed
    point (the native library's search), and its FPS downsample to
    ``fps_ratio`` of the patch. Returns ({patch_pos, ds_pos}, patch_idx,
    fps_idx); ``fps=False`` skips the downsample (``ds_pos`` and
    ``fps_idx`` None)."""
    rng = rng or np.random.default_rng()
    total = input_pos.shape[0]
    if sample_num is None:
        patch_num = 9216 if total > 10000 else (total // 1024) * 1024
    else:
        patch_num = sample_num if total > sample_num else 4096
    patch_num = min(patch_num, total)
    seed = int(rng.integers(total))
    patch_idx = native.knn_patch(input_pos, seed, patch_num)
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


def _voxel_means(pos: np.ndarray, voxel: float, *cols: np.ndarray):
    """The f32 means of ``pos`` and of each of ``cols`` over each occupied
    voxel of edge ``voxel`` (anchored at the cloud's minimum), in the
    voxels' lexicographic key order."""
    keys = np.floor((pos - pos.min(0)) / voxel).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    inverse = inverse.reshape(-1)
    out = []
    for a in (pos, *cols):
        sums = np.zeros((counts.shape[0], a.shape[1]), np.float64)
        np.add.at(sums, inverse, a)
        out.append((sums / counts[:, None]).astype(np.float32))
    return out


def voxel_downsample(pos: np.ndarray, radius: float, ds_ratio: float,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """One point per occupied voxel of edge radius / ds_ratio (its
    centroid), then a random subset of ds_ratio times the input count
    where more voxels are occupied (the reference's Open3D
    ``voxel_down_sample``, train_utils.py:13-30)."""
    rng = rng or np.random.default_rng()
    pos = pos.reshape(-1, 3)
    (ds_pos,) = _voxel_means(pos, (1.0 / ds_ratio) * radius + 1e-9)
    target = int(ds_ratio * pos.shape[0])
    if ds_pos.shape[0] > target:
        ds_pos = ds_pos[rng.choice(ds_pos.shape[0], target, replace=False)]
    return ds_pos


def voxel_downsample_with_feat(pos: np.ndarray, feat: np.ndarray,
                               radius: float, ds_ratio: float,
                               rng: Optional[np.random.Generator] = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`voxel_downsample` carrying per-point features as voxel means
    (reference train_utils.py:68-95)."""
    rng = rng or np.random.default_rng()
    pos = pos.reshape(-1, 3)
    ds_pos, ds_feat = _voxel_means(pos, (1.0 / ds_ratio) * radius + 1e-9,
                                   feat)
    target = int(ds_ratio * pos.shape[0])
    if ds_pos.shape[0] > target:
        sel = rng.choice(ds_pos.shape[0], target, replace=False)
        ds_pos, ds_feat = ds_pos[sel], ds_feat[sel]
    return ds_pos, ds_feat


def sample_patch(input_pos: np.ndarray, h: float = 1.0,
                 return_free_surface_particles: bool = True,
                 rng: Optional[np.random.Generator] = None):
    """The voxel-downsampled patch sampler (reference train_utils.py:33-65):
    a kd-tree patch around a random seed, of 32,768, 16,384 or 8,192
    points by the cloud's size (the whole cloud up to 10,000), downsampled
    by voxels at ratio 0.5, drawn again until the downsample keeps at least
    500 points (at most 100 draws). (patch, downsample[, free-surface
    particles of the patch])."""
    rng = rng or np.random.default_rng()
    total = input_pos.shape[0]
    patch_num = (32768 if total > 80000 else 16384 if total > 40000
                 else 8192 if total > 10000 else total)
    tree = cKDTree(input_pos)
    for _ in range(100):
        seed = input_pos[rng.integers(total)]
        _, patch = tree.query(seed, patch_num)
        patch_pos = input_pos[patch]
        ds_pos = voxel_downsample(patch_pos, radius=BASE_RADIUS / h,
                                  ds_ratio=0.50, rng=rng)
        if ds_pos.shape[0] >= 500 or patch_num < 1000:
            break
    else:
        raise RuntimeError("Abnormal sampling times!")
    if return_free_surface_particles:
        surface = get_free_surface_particles(patch_pos, 2.2 * BASE_RADIUS / h)
        return patch_pos, ds_pos, surface
    return patch_pos, ds_pos


def filter_overlap_particles(pos: np.ndarray, h: float = BASE_RADIUS * 0.5
                             ) -> np.ndarray:
    """Near-coincident particles merged by voxel hashing: one centroid per
    occupied voxel of edge h (reference train_utils.py:241-255)."""
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    return _voxel_means(pos, h + 1e-8)[0]


def get_distribution_info(points: np.ndarray):
    """(centroid, min bound, max bound) of a cloud (reference
    train_utils.py:201-211)."""
    return points.mean(0), points.min(0), points.max(0)
