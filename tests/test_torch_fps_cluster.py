"""The FPS kernel's launch plan and its tie rule, for the two variants of
``csrc/fps.cu`` (a row on one warp, a row on a thread-block cluster).

* ``fps_plan`` at the train step's six FPS stages (``chip_smoke.FPS_SHAPES``),
  at N = 1, at N = ``MAX_POINTS`` and at N off every multiple of the
  blocks' slices: the blocks' slices and the threads' slots hold every point
  exactly once, with fewer dead slots than threads, within the register
  budget; beyond ``MAX_POINTS`` the plan refuses.
* ``fps_plain`` (the kernel's oracle on the card) against the Pallas kernel
  ``fps_pallas`` in interpret mode and the JAX package's ``fps`` on
  tie-heavy rows (lattice points at multiples of 0.25, whose distances are
  exact in f32; duplicated points), rows that run out of valid points, an
  invalid start and a row with no valid point.
* A numpy emulation of the kernel's reduction (each thread's first
  maximum over its contiguous points, then per warp the largest order key
  and the first lane that holds it, then the largest key over the
  cluster's warp slots and the first slot that holds it, each lane taking
  a contiguous run of slots) under several launch shapes: its selections
  equal ``fps_plain``'s, so the design's first-owner rule is the global
  first argmax.
* Marked ``gpu`` (skipped without a card): the kernel against
  ``fps_plain`` at the six stages and on the tie, exhaustion, N = 1,
  m = 1 and B = 0 rows, under every cluster size, and the refusal beyond
  ``MAX_POINTS``. On the card: ``python -m pytest --noconftest
  -p no:cacheprovider tests/test_torch_fps_cluster.py -m gpu``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpugan_tpu_torch.ops.kernels import fps as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import FPS_SHAPES  # noqa: E402

BIG = np.float32(1e10)


@pytest.fixture
def gen():
    # a local generator: on the card this file runs with --noconftest
    return np.random.default_rng(0)


# ---------------------------------------------------------------- the plan

def owners(plan, n):
    """Point index of every (block, thread, slot) of one row, as fps.cu lays
    them out: block c, thread t, slot k -> c * slice + t * ppt + k."""
    c, t, k = np.meshgrid(np.arange(plan.cluster), np.arange(plan.threads),
                          np.arange(plan.ppt), indexing="ij")
    return c * plan.slice + t * plan.ppt + k


PLAN_NS = sorted({n for _, _, n, _, _, _ in FPS_SHAPES}
                 | {1, 31, 33, 1025, 5000, 9217, 14335, F.MAX_POINTS})


@pytest.mark.parametrize("n", PLAN_NS)
def test_plan_covers_every_point_once_within_the_budget(n):
    plan = F.fps_plan(n)
    assert plan.admits(n)
    i = owners(plan, n).ravel()
    held = np.sort(i[i < n])
    np.testing.assert_array_equal(held, np.arange(n))     # each point once
    slots = plan.cluster * plan.threads
    assert plan.cluster * plan.slice - n < slots          # ppt is the least
    if plan.variant == "warp":
        assert n <= F.WARP_POINTS and plan.ppt <= F.WARP_PPT_MAX
    else:
        assert n > F.WARP_POINTS and plan.ppt <= F.CLUSTER_PPT_MAX
        assert plan.threads <= F.CLUSTER_THREADS_MAX
        assert plan.cluster <= F.PLAN_CLUSTER_MAX


def test_plan_at_the_train_stages():
    """Rows of 512 points take one warp, 16 points a lane; rows of 1,024 one
    block of 128 threads, 8 points each; rows of 9,216 a cluster of 8 such
    blocks, 9 points each: no dead slot at any stage."""
    got = {n: F.fps_plan(n) for _, _, n, _, _, _ in FPS_SHAPES}
    assert got[512] == F.FpsPlan("warp", 1, 32, 16)
    assert got[1024] == F.FpsPlan("cluster", 1, 128, 8)
    assert got[9216] == F.FpsPlan("cluster", 8, 128, 9)
    assert all(p.cluster * p.slice == n for n, p in got.items())


@pytest.mark.parametrize("n", [0, F.MAX_POINTS + 1, 20000])
def test_plan_refuses_outside_the_rows_the_kernel_takes(n):
    with pytest.raises(ValueError, match="fps kernel takes N <= 14336"):
        F.fps_plan(n)


@pytest.mark.parametrize("plan,n,ok", [
    (F.FpsPlan("warp", 1, 32, 32), 1024, True),
    (F.FpsPlan("warp", 1, 32, 32), 1025, False),
    (F.FpsPlan("warp", 1, 64, 16), 1024, False),
    (F.FpsPlan("warp", 2, 32, 16), 1024, False),
    (F.FpsPlan("cluster", 8, 128, 9), 9216, True),
    (F.FpsPlan("cluster", 8, 128, 9), 9217, False),
    (F.FpsPlan("cluster", 16, 32, 1), 512, True),
    (F.FpsPlan("cluster", 17, 32, 1), 512, False),
    (F.FpsPlan("cluster", 1, 48, 4), 64, False),
    (F.FpsPlan("cluster", 1, 288, 1), 64, False),
    (F.FpsPlan("cluster", 1, 32, 17), 64, False),
    (F.FpsPlan("tree", 1, 32, 1), 8, False),
])
def test_plan_admits_only_the_shapes_the_kernel_takes(plan, n, ok):
    assert plan.admits(n) is ok


# ------------------------------------------------- tie-heavy and exhausted rows

def _rows(kind, gen):
    """(pos [B, N, 3] f32, penalty [B, N] f32, start [B] int64, m)."""
    b, n = 3, 96
    pen = np.zeros((b, n), np.float32)
    start = np.array([0, 17, 95])
    if kind == "lattice":       # multiples of 0.25: exact distances, ties
        pos = gen.integers(-4, 5, (b, n, 3)) * np.float32(0.25)
        m = 64
    elif kind == "duplicated":  # 24 points, each 4 times, shuffled
        base = gen.standard_normal((b, 24, 3)).astype(np.float32)
        pos = np.stack([base[i][gen.permutation(np.repeat(np.arange(24), 4))]
                        for i in range(b)])
        m = 64
    elif kind == "exhausted":   # 20 valid points, m = 48: the -1e10 points
        pos = gen.standard_normal((b, n, 3)).astype(np.float32)
        pen[:, 20:] = -BIG      # far away and at distinct distances
        pos[:, 20:] = gen.standard_normal((b, n - 20, 3)) * 300.0
        start = np.array([0, 5, 19])
        m = 48
    elif kind == "invalid_start":
        pos = gen.standard_normal((b, n, 3)).astype(np.float32)
        pen[:, ::3] = -BIG
        start = np.array([0, 33, 93])       # each an invalid point
        m = 40
    elif kind == "no_valid_point":          # the whole of row 1 invalid
        pos = (gen.integers(-8, 9, (b, n, 3)) * np.float32(0.25)
               + np.float32(100.0) * (np.arange(b) == 1)[:, None, None])
        pen[1] = -BIG
        m = 40
    return pos.astype(np.float32), pen, start.astype(np.int64), m


def tied_rounds(pos, pen, idx):
    """Rounds of the selections ``idx`` whose maximum more than one point
    held (numpy, the plain version's arithmetic)."""
    ties = 0
    for row in range(pos.shape[0]):
        mind = np.full(pos.shape[1], np.inf, np.float32)
        for s in idx[row, :-1]:
            d = pos[row] - pos[row, s]
            mind = np.minimum(mind, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                              + d[:, 2] * d[:, 2] + pen[row])
            ties += int((mind == mind.max()).sum() > 1)
    return ties


ROW_KINDS = ["lattice", "duplicated", "exhausted", "invalid_start",
             "no_valid_point"]


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_plain_matches_pallas_and_jax_on_tie_and_exhausted_rows(gen, kind):
    import jax.numpy as jnp

    from tpugan_tpu.ops.neighbors import fps as jax_fps
    from tpugan_tpu.ops.pallas.fps_kernel import fps_pallas

    pos, pen, start, m = _rows(kind, gen)
    got = F.fps_plain(torch.from_numpy(pos), m, torch.from_numpy(pen),
                      torch.from_numpy(start)).numpy()
    ref = np.asarray(fps_pallas(jnp.asarray(pos), m, jnp.asarray(pen),
                                jnp.asarray(start, jnp.int32)))
    np.testing.assert_array_equal(got, ref)
    # the JAX package's fps starts every row at one index, and moves an
    # invalid start to the row's first valid point
    valid = pen == 0
    for row in range(pos.shape[0]):
        if not valid[row, start[row]]:
            continue
        want = np.asarray(jax_fps(jnp.asarray(pos[row:row + 1]), m,
                                  valid=jnp.asarray(valid[row:row + 1]),
                                  start_idx=int(start[row])))
        np.testing.assert_array_equal(got[row:row + 1], want)
    if kind != "invalid_start":              # the rows do hold exact ties
        assert tied_rounds(pos, pen, got) > 0
    if kind == "exhausted":                  # every valid point, then repeats
        assert set(got[0, :20]) == set(range(20))
        assert (got[:, 20:] < 20).all()


# ------------------------------------------------ the kernel's reduction

def order_key(v):
    """fps.cu's order_key: -0 -> +0, then the order-preserving bit map;
    -inf (no point) -> 0."""
    u = (v + np.float32(0.0)).astype(np.float32).view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(v == -np.inf, np.uint32(0), key)


def first_max(keys):
    """fps.cu's warp_first_max along the last axis: the largest key, and
    the first position holding it."""
    top = keys.max(-1)
    return top, np.argmax(keys == top[..., None], -1)


def emulate_select(mind, plan):
    """The index fps.cu selects from one row's mind [N] under ``plan``."""
    n = mind.size
    v = np.full(plan.cluster * plan.slice, -np.inf, np.float32)
    v[:n] = mind
    # [block, thread, slot k]: point c * slice + t * ppt + k
    v = v.reshape(plan.cluster, plan.threads, plan.ppt)
    k = np.argmax(v, axis=2)            # the tree: first of a tie
    key = order_key(np.take_along_axis(v, k[..., None], 2)[..., 0])
    # per warp: the largest key and the first lane holding it
    warps = plan.threads // 32
    top, lane = first_max(key.reshape(plan.cluster, warps, 32))
    thread = np.arange(warps) * 32 + lane                   # [C, W]
    local = thread * plan.ppt + np.take_along_axis(
        k, thread, 1)
    slot_key = top.ravel()                                  # slot c W + w
    slot_idx = (np.arange(plan.cluster)[:, None] * plan.slice + local).ravel()
    # the slots: each lane's contiguous run, then the first lane holding
    # the largest key
    per_lane = -(-slot_key.size // 32)
    runs = np.zeros(32 * per_lane, np.uint32)
    runs[:slot_key.size] = slot_key
    lane_top, at = first_max(runs.reshape(32, per_lane))
    top, from_lane = first_max(lane_top)
    return int(slot_idx[from_lane * per_lane + at[from_lane]])


def emulate_fps(pos, m, pen, start, plan):
    b, n, _ = pos.shape
    out = np.empty((b, m), np.int64)
    for row in range(b):
        p, s = pos[row], int(start[row])
        out[row, 0] = s
        mind = np.full(n, np.inf, np.float32)
        for r in range(1, m):
            d = p - p[s]
            dist = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            mind = np.minimum(mind, dist + pen[row])
            s = emulate_select(mind, plan)
            out[row, r] = s
    return out


EMULATED_PLANS = [F.FpsPlan("warp", 1, 32, 3), F.FpsPlan("cluster", 1, 96, 1),
                  F.FpsPlan("cluster", 2, 32, 2), F.FpsPlan("cluster", 4, 32, 1),
                  F.FpsPlan("cluster", 8, 32, 1), F.FpsPlan("cluster", 16, 32, 1),
                  F.FpsPlan("cluster", 3, 64, 1), F.FpsPlan("cluster", 8, 256, 1)]


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_emulated_reduction_is_the_first_argmax(gen, kind):
    pos, pen, start, m = _rows(kind, gen)
    want = F.fps_plain(torch.from_numpy(pos), m, torch.from_numpy(pen),
                       torch.from_numpy(start)).numpy()
    for plan in EMULATED_PLANS:
        assert plan.admits(pos.shape[1]), plan
        np.testing.assert_array_equal(emulate_fps(pos, m, pen, start, plan),
                                      want, err_msg=str(plan))


def test_order_key_keeps_the_order_of_the_values():
    v = np.array([-np.inf, -1e10 - 2048, -1e10, -3.5, -1e-30, -0.0, 0.0,
                  1e-30, 0.25, 1.0, 3e6, np.inf], np.float32)
    k = order_key(v)
    assert (np.diff(k[:5].astype(np.int64)) > 0).all()
    assert k[5] == k[6]                      # -0 and +0 are one key
    assert (np.diff(k[6:].astype(np.int64)) > 0).all()
    assert k[0] == 0 and k[1] > 0            # no point below every point


def test_emulated_ties_across_blocks_keep_the_lowest_index():
    """One value, tied at points that lie in different blocks, warps and
    slots: the lowest index wins under every launch shape."""
    mind = np.full(96, -BIG, np.float32)
    mind[[95, 70, 33, 40, 64]] = 2.0
    mind[[5]] = -0.0
    for plan in EMULATED_PLANS:
        assert emulate_select(mind, plan) == 33, plan
    mind[[33, 40, 64, 70, 95]] = 0.0                    # +0 ties -0 at 5
    for plan in EMULATED_PLANS:
        assert emulate_select(mind, plan) == 5, plan


# ---------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _on(card, *ts):
    return [t.to(card) for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("stage,b,n,m,masked", [s[:5] for s in FPS_SHAPES])
def test_kernel_matches_plain_at_the_train_stages(card, gen, stage, b, n, m,
                                                  masked):
    pos = torch.from_numpy((gen.standard_normal((b, n, 3)) * 0.3)
                           .astype(np.float32))
    pen = torch.zeros(b, n)
    if masked:
        pen[:, -n // 8:] = -1e10
        pos[:, -n // 8:] = 999.0
    start = torch.from_numpy(gen.integers(0, n - n // 8, b))
    before = F.KERNEL.launches
    got = F.fps_kernel(*_on(card, pos), m, *_on(card, pen, start))
    assert F.KERNEL.launches == before + 1
    want = F.fps_plain(*_on(card, pos), m, *_on(card, pen, start))
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ROW_KINDS)
def test_kernel_matches_plain_on_tie_and_exhausted_rows(card, gen, kind):
    pos, pen, start, m = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in _rows(kind, gen))
    want = F.fps_plain(pos, m, pen, start)
    for plan in [None, *EMULATED_PLANS]:
        got = F.fps_kernel(*_on(card, pos), m, *_on(card, pen, start), plan=plan)
        assert torch.equal(got.cpu(), want), plan


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m", [(3, 1, 5), (2, 1000, 1), (0, 500, 10),
                                   (2, 1025, 30), (2, F.MAX_POINTS, 20)])
def test_kernel_matches_plain_at_the_edges(card, gen, b, n, m):
    pos = torch.from_numpy(gen.standard_normal((b, n, 3)).astype(np.float32))
    pen = torch.zeros(b, n)
    start = torch.from_numpy(gen.integers(0, n, b))
    got = F.fps_kernel(*_on(card, pos), m, *_on(card, pen, start))
    assert got.shape == (b, m)
    assert torch.equal(got.cpu(), F.fps_plain(pos, m, pen, start))


@pytest.mark.gpu
def test_kernel_refuses_rows_beyond_max_points(card):
    n = F.MAX_POINTS + 1
    with pytest.raises(ValueError, match="fps kernel takes N <= 14336"):
        F.fps_kernel(torch.zeros(1, n, 3, device=card), 4,
                     torch.zeros(1, n, device=card),
                     torch.zeros(1, dtype=torch.int64, device=card))
