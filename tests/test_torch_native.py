"""The port's native host library (``tpugan_tpu_torch/data/native.py`` over
``tpugan_tpu_torch/native/tpugan_native.cpp``) against the JAX package's
(``tpugan_tpu/data/native.py`` over ``native/tpugan_native.cpp``), on the
CPU: one source built with one compiler and the same flags, so every entry
point returns the JAX library's bits. Each is also held to its meaning:
the patch is the kd-tree query's set, the radius counts scipy's, the voxel
rows each voxel's centroid. Then the loaders' items on both libraries from
one seed, the build's file name, and a build that cannot run.

The JAX package's library builds at first use (``make -C native``); where
it cannot, the comparisons skip.
"""

import sys
import threading

import numpy as np
import pytest
from scipy.spatial import cKDTree

import tpugan_tpu.data.native as jax_native
from tpugan_tpu.data.fluid import SiamFluidDataset as JFluid
from tpugan_tpu.data.msr import MSRAction3DDataset as JMSR
from tpugan_tpu_torch.data import native as tnative
from tpugan_tpu_torch.data import sampling as tsampling
from tpugan_tpu_torch.data.fluid import SiamFluidDataset
from tpugan_tpu_torch.data.msr import MSRAction3DDataset
from tpugan_tpu_torch.data.synthetic import (make_synthetic_action_dataset,
                                             make_synthetic_fluid_dataset)


@pytest.fixture
def jax_lib():
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not built")


def _cloud(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((n, 3)).astype(np.float32)
    if kind == "uniform":
        return rng.uniform(0, 1, (n, 3)).astype(np.float32)
    # a blob on a coarse grid: many exactly equal distances
    return (np.round(rng.standard_normal((n, 3)) * 8) / 8).astype(np.float32)


@pytest.mark.parametrize("n,k", [(9216, 1152), (2048, 128), (500, 50)])
@pytest.mark.parametrize("seed,kind", [(0, "normal"), (1, "uniform"),
                                       (2, "grid")])
def test_fps_equals_jax_library(jax_lib, n, k, seed, kind):
    """FPS indices from random starts, bit for bit; the first pick is the
    start and no index repeats before the cloud runs out of distinct
    points."""
    pts = _cloud(seed, n, kind)
    for start in np.random.default_rng(seed + 10).integers(0, n, 2):
        got = tnative.fps(pts, k, start=int(start))
        want = jax_native.fps(pts, k, start=int(start))
        assert got.dtype == np.int64 and got.shape == (k,)
        np.testing.assert_array_equal(got, want)
        assert got[0] == start
        if kind != "grid":
            assert len(set(got.tolist())) == k


@pytest.mark.parametrize("n,k", [(12000, 9216), (5000, 1024), (700, 64)])
@pytest.mark.parametrize("seed,kind", [(0, "normal"), (1, "uniform"),
                                       (2, "grid")])
def test_knn_patch_equals_jax_library_and_kdtree_set(jax_lib, n, k, seed,
                                                      kind):
    """Patch indices bit for bit, ascending by distance from the seed; on
    clouds without ties at the k-th distance the kd-tree query's set."""
    pts = _cloud(seed, n, kind)
    seed_idx = int(np.random.default_rng(seed + 20).integers(n))
    got = tnative.knn_patch(pts, seed_idx, k)
    np.testing.assert_array_equal(got, jax_native.knn_patch(pts, seed_idx, k))
    d = np.sum((pts[got].astype(np.float64) - pts[seed_idx]) ** 2, -1)
    assert np.all(np.diff(d) >= -1e-6 * d.max())
    if kind != "grid":
        want = cKDTree(pts).query(pts[seed_idx], k)[1]
        np.testing.assert_array_equal(np.sort(got), np.sort(want))


@pytest.mark.parametrize("n,radius", [(800, 0.4), (3000, 0.1), (3000, 0.25)])
@pytest.mark.parametrize("seed,kind", [(0, "normal"), (1, "uniform")])
def test_radius_count_equals_jax_library_and_kdtree(jax_lib, n, radius, seed,
                                                    kind):
    pts = _cloud(seed, n, kind)
    got = tnative.radius_count(pts, radius)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_native.radius_count(pts, radius))
    want = cKDTree(pts).query_ball_point(pts, radius, return_length=True)
    np.testing.assert_array_equal(got, want)


def _sorted_rows(a):
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("n,voxel", [(2000, 0.2), (5000, 0.05)])
@pytest.mark.parametrize("seed,kind", [(0, "normal"), (1, "uniform")])
def test_voxel_downsample_equals_jax_library_and_centroids(jax_lib, n, voxel,
                                                           seed, kind):
    """Sorted rows bit for bit; each row is its voxel's centroid (f64 sums
    in index order over f32 keys, as the library forms them)."""
    pts = _cloud(seed, n, kind)
    got = tnative.voxel_downsample(pts, voxel)
    want = jax_native.voxel_downsample(pts, voxel)
    np.testing.assert_array_equal(_sorted_rows(got), _sorted_rows(want))
    keys = np.floor((pts - pts.min(0)) / np.float32(voxel)).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    sums = np.zeros((counts.shape[0], 3), np.float64)
    np.add.at(sums, inverse.reshape(-1), pts.astype(np.float64))
    centroids = (sums / counts[:, None]).astype(np.float32)
    np.testing.assert_array_equal(_sorted_rows(got), _sorted_rows(centroids))


def test_loader_takes_the_library_and_counts_calls(rng):
    """farthest_point_sampling and sample_patch_with_fps go through the
    library (one call each an FPS and a patch); the plain versions return
    the same function's indices on a cloud without near ties."""
    pos = rng.standard_normal((3000, 3)).astype(np.float32)
    before = dict(tnative.CALLS)
    idx, dist = tsampling.farthest_point_sampling(pos, 100, initial_idx=7)
    assert dist.shape == (0,)
    np.testing.assert_array_equal(idx, tsampling.fps_plain(pos, 100, 7))
    out, patch_idx, fps_idx = tsampling.sample_patch_with_fps(
        pos, 1024, 0.125, rng=np.random.default_rng(3))
    assert (tnative.CALLS["fps"] - before["fps"],
            tnative.CALLS["knn_patch"] - before["knn_patch"]) == (2, 1)
    seed = int(np.random.default_rng(3).integers(3000))
    want = tsampling.knn_patch_plain(pos, seed, 1024)
    np.testing.assert_array_equal(np.sort(patch_idx), np.sort(want))
    assert out["ds_pos"].shape == (128, 3)


@pytest.fixture(scope="module")
def fluid_root(tmp_path_factory):
    return make_synthetic_fluid_dataset(
        str(tmp_path_factory.mktemp("native_fluid")), case_num=1,
        case_steps=4, num_particles=12000, seed=11)


@pytest.fixture(scope="module")
def msr_root(tmp_path_factory):
    return make_synthetic_action_dataset(
        str(tmp_path_factory.mktemp("native_msr")), num_videos=4, frames=6,
        points=3000, seed=4)


def test_loader_items_on_the_libraries_equal_jax(jax_lib, fluid_root,
                                                 msr_root):
    """A SiamFluidDataset item at the recipe's 9,216-point patch with its
    1,152-point FPS downsample, and an MSR train clip of 3 frames of 2,048
    points with 128-point downsamples, from the port's loader on its
    library and the JAX loader on its own, one seed: equal array for
    array."""
    kw = dict(sample_num=9216, fps_ratio=0.125, jitter=0.003, seed=5)
    ours = SiamFluidDataset(fluid_root, 1, 4, emit_lowres=True, **kw)
    theirs = JFluid(fluid_root, 1, 4, emit_lowres=True, **kw)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["lowres_pos"].shape == (3, 1152, 3)
    kw = dict(frames_per_clip=3, num_points=2048, fps_ratio=0.0625, seed=6)
    ours, theirs = MSRAction3DDataset(msr_root, **kw), JMSR(msr_root, **kw)
    assert len(ours) == len(theirs) > 0
    for i in (0, len(ours) - 1):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["lowres_pos"].shape == (3, 128, 3)


def test_port_never_reads_the_jax_library():
    """The port builds its own copy; no module of it names the JAX
    package's library file or runs its Makefile."""
    root = tnative.SOURCE.parent.parent
    assert root.name == "tpugan_tpu_torch"
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "libtpugan_native.so" not in text, path
        assert '"make"' not in text, path


def test_library_name_carries_source_compiler_flags_and_host():
    src = tnative.SOURCE.read_bytes()
    default = tnative.library_path()
    assert default == tnative.library_path(src, tnative.compiler())
    assert default.parent == tnative.BUILD_DIR
    assert tnative.library_path(src + b"\n") != default
    assert tnative.library_path(src, "clang++") != default
    assert tnative.SOURCE.parent.parent.name == "tpugan_tpu_torch"
    assert "-march=native" in tnative.CXXFLAGS
    assert tnative.host_cpu()


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch, rng):
    """A compiler that is not there: the build raises with the command, the
    loader's FPS raises too (no numpy fallback), nothing is left built."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native library"):
        tnative.build(build_dir=tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_LIB", None)
    pts = rng.standard_normal((100, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tsampling.farthest_point_sampling(pts, 10, initial_idx=0)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_concurrent_builds_compile_once(tmp_path):
    """Builds that start together in one build directory wait on its lock
    and load one library: one file, no temporary left."""
    paths, errors = [], []

    def one():
        try:
            paths.append(tnative.build(build_dir=tmp_path))
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors
    assert len(set(paths)) == 1 and paths[0].exists()
    assert [p.name for p in tmp_path.glob("*.so")] == [paths[0].name]
    assert not list(tmp_path.glob("*.tmp"))


def test_call_counts_lose_no_update_under_threads():
    """Sixteen threads (more than the cores) calling the library at once,
    the interpreter switching threads every microsecond: every call
    counted once (the loader's pool threads call it concurrently)."""
    pts = np.random.default_rng(2).standard_normal((64, 3)).astype(np.float32)
    tnative.fps(pts, 4)                 # built and loaded before the race
    before = tnative.CALLS["fps"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [tnative.fps(pts, 4) for _ in range(50)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert tnative.CALLS["fps"] - before == 16 * 50
