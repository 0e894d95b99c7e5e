"""The approximate kNN kernel on the tensor cores (``csrc/knn.cu : approx``):
its launch plan and a numpy emulation of its scheme.

* ``knn_approx_plan`` at every ``chip_smoke.APPROX_SHAPES`` row and the eval
  sample's 4,096-point graphs: one wave that leaves no SM idle; at edge
  sizes (one query, many rows) and out-of-range shapes refused; the model's
  waves; the instances' shared memory fits their blocks an SM; the scratch
  layout.
* A numpy emulation of the kernel: rows rounded to bf16 and zero-padded to
  16, 32 or 64 features, |p|^2 from the f32 values in feature order; the
  cross term as f32 partial sums of 16 features added in k16 order (the
  tensor cores' steps); every (query, lane column) cell owned by exactly one
  thread of one warp (query tile x column split, rows g and g + 8, columns
  2t and 2t + 1 of each n8 slice); each cell's kp-deep list built tile by
  tile by the kernel's min / max network; the lists dumped to the
  [query][kp][128] layout (each slot written once) and the k smallest taken
  in k rounds over the lanes' column heads. It equals ``knn_approx_plain``
  within ``knn.approx_agreement`` on random clouds, and bit for bit on the
  duplicated grid, the sentinel-padded frame and the dropped-neighbour case,
  under each query tile (WQ = 2, 5), from k = 3 to k = 128 kp.

On the card ``tests/test_torch_port.py`` (marked gpu) runs the kernel under
each plan against its plain version.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpugan_tpu_torch import PAD_SENTINEL
from tpugan_tpu_torch.ops.kernels import knn as K

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import APPROX_SHAPES  # noqa: E402

SMS = 132
NONE = np.uint64(0xFFFFFFFF)
TILE = 128                      # candidates a tile: one row of lane columns
SMEM_SM = 228 * 1024            # shared memory of an H100 SM
SMEM_BLOCK_RESERVED = 1024      # reserved by the runtime for each block


# ---------------------------------------------------------------- the plan

MAIN_SHAPES = sorted({(n, d, k) for _, n, d, k, *_ in APPROX_SHAPES}
                     | {(4096, 3, 20), (4096, 32, 20), (4096, 64, 12)})


@pytest.mark.parametrize("n,d,k", MAIN_SHAPES)
def test_plan_runs_the_main_shapes_in_one_wave_on_every_sm(n, d, k):
    plan = K.knn_approx_plan(1, n, n, d, k, SMS)
    blocks = plan.blocks(1, n)
    assert plan.admits() and plan.waves(1, n, SMS) == 1
    assert blocks * plan.queries >= n > (blocks - 1) * plan.queries
    assert 0.9 * SMS <= blocks <= SMS * plan.per_sm
    # the 10,240- and 10,112-point graphs take the 80-query blocks, the
    # 4,096-point graphs the 32-query ones (the fastest in the card sweep)
    assert plan.wq == (5 if n > 8192 else 2)


@pytest.mark.parametrize("b,nq", [(1, 1), (1, 15), (1, 17), (1, 160),
                                  (1, 2112), (3, 1000), (2, 4096),
                                  (4, 4096), (2, 10112), (65535, 1),
                                  (7, 10240)])
def test_plan_minimises_its_model_and_counts_waves(b, nq):
    plan = K.knn_approx_plan(b, nq, 4096, 3, 20, SMS)
    others = [K.ApproxPlan(wq) for wq in K.APPROX_BLOCKS_PER_SM]
    cost = lambda p: (K._approx_cost(p, b, nq, SMS), p.blocks(b, nq))
    assert cost(plan) == min(cost(p) for p in others)
    for p in others:
        per_sm = -(-p.blocks(b, nq) // SMS)
        assert p.waves(b, nq, SMS) == -(-per_sm // p.per_sm)


@pytest.mark.parametrize("args", [
    (0, 10, 4096, 3, 20), (65536, 10, 4096, 3, 20), (1, 0, 4096, 3, 20),
    (1, 10, 4000, 3, 20),            # Nc off the 128-column rows
    (1, 10, 3968, 3, 20),            # below the approximate mode's 4,096
    (1, 10, 65536, 3, 20),           # keys hold 16-bit indices
    (1, 10, 4096, 65, 20), (1, 10, 4096, 0, 20),
    (1, 10, 4096, 3, 2),             # k < 3: the exact mode
    (1, 10, 4096, 3, 385),           # k > 128 kp
])
def test_plan_refuses_shapes_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        K.knn_approx_plan(*args, SMS)


def test_plan_refuses_a_card_without_sms():
    with pytest.raises(ValueError):
        K.knn_approx_plan(1, 10, 4096, 3, 20, 0)


@pytest.mark.parametrize("wq", [1, 3, 4])
def test_forced_launch_refuses_an_instance_that_is_not_built(wq):
    t = torch.zeros(1, 4096, 3)
    with pytest.raises(ValueError, match="not built"):
        K._launch_approx(t, t, torch.zeros(1, 4096), 20, K.ApproxPlan(wq))


@pytest.mark.parametrize("d,dk", [(1, 16), (3, 16), (16, 16), (17, 32),
                                  (32, 32), (33, 64), (64, 64)])
def test_rows_pad_to_whole_k16_steps(d, dk):
    assert K.approx_dk(d) == dk


@pytest.mark.parametrize("self_graph", [True, False])
def test_scratch_holds_the_prepared_rows_on_16_byte_boundaries(self_graph):
    b, nq, nc, d = 3, 1001, 4096, 32
    dk = K.approx_dk(d)
    got = K.approx_scratch_bytes(b, nq, nc, d, self_graph)
    parts = [b * nc * dk * 2, b * nc * 8]
    if not self_graph:
        parts += [b * nq * dk * 2, b * nq * 4]
    assert got == sum(-(-p // 16) * 16 for p in parts) >= sum(parts)


@pytest.mark.parametrize("wq", sorted(K.APPROX_BLOCKS_PER_SM))
@pytest.mark.parametrize("dk", [16, 32, 64])
@pytest.mark.parametrize("kp", [2, 3])
def test_instances_shared_memory_fits_their_blocks_an_sm(wq, dk, kp):
    """max(2 tile buffers, the lists) a block, as csrc/knn.cu lays it out,
    times the blocks an SM its launch bounds promise."""
    tiles = 2 * (TILE * (dk + 8) * 2 + TILE * 8)
    lists = 16 * wq * (kp * TILE + 8) * 4
    per_block = max(tiles, lists) + SMEM_BLOCK_RESERVED
    assert K.APPROX_BLOCKS_PER_SM[wq] * per_block <= SMEM_SM
    # and the registers: 128 wq threads at the instance's cap
    cap = {2: 128, 5: 96}[wq]
    assert K.APPROX_BLOCKS_PER_SM[wq] * 128 * wq * cap <= 65536


# ------------------------------------------------------- the kernel emulated

def bf16_bits(x):
    """Round-to-nearest-even bf16 bits of f32 values (as cvt.rn.bf16x2)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF


def bf16_values(x):
    return (bf16_bits(x).astype(np.uint32) << 16).view(np.float32)


def prep(x, dk):
    """approx_prep: bf16 rows padded to dk, |p|^2 by a chain of f32 fmas in
    feature order (a float64 product and sum rounded once to f32 is the
    fma for these inputs: the products are exact in float64)."""
    n, d = x.shape[-2:]
    rows = np.zeros(x.shape[:-1] + (dk,), np.float32)
    rows[..., :d] = bf16_values(x)
    s = np.zeros(x.shape[:-1], np.float32)
    for j in range(d):
        s = (s.astype(np.float64) + x[..., j].astype(np.float64) ** 2).astype(np.float32)
    return rows, s


def cross_term(qh, ch):
    """q.c of bf16 rows as the tensor cores' k16 steps: each step's 16
    products summed in f32, the steps added to the f32 accumulator in
    order."""
    acc = np.zeros(qh.shape[:-1] + (ch.shape[-2],), np.float32)
    for k0 in range(0, qh.shape[-1], 16):
        step = np.einsum("bqd,bcd->bqc", qh[..., k0:k0 + 16].astype(np.float64),
                         ch[..., k0:k0 + 16].astype(np.float64))
        acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


def keys(q, c, bias):
    """[B, Nq, Nc] uint64 keys of the contract, by the kernel's arithmetic."""
    dk = K.approx_dk(q.shape[-1])
    qh, q2 = prep(q, dk)
    ch, c2 = prep(c, dk)
    acc = cross_term(qh, ch)
    s = (q2[:, :, None] + c2[:, None, :]).astype(np.float32)
    v = (s - np.float32(2) * acc).astype(np.float32)       # the fma: 2 acc exact
    v = (np.maximum(v, np.float32(0)) + bias[:, None, :]).astype(np.float32)
    return (bf16_bits(v) << np.uint64(16)) | np.arange(c.shape[1], dtype=np.uint64)


def owners(wq):
    """For a block of wq query tiles: (row, column) -> (warp, lane, h, cell)
    of the thread that keeps that cell's list (the accumulator fragment of
    mma.m16n8k16: rows g and g + 8, columns 2t and 2t + 1 of each of the
    warp's 4 n8 slices)."""
    own = {}
    for warp in range(4 * wq):
        w_q, w_c = divmod(warp, 4)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for h in range(2):
                for cell in range(8):
                    row = 16 * w_q + g + 8 * h
                    col = 32 * w_c + 8 * (cell >> 1) + 2 * t + (cell & 1)
                    assert (row, col) not in own
                    own[row, col] = (warp, lane, h, cell)
    return own


def insert(lists, x):
    """The kernel's min / max network on sorted [..., kp] lists."""
    kp = lists.shape[-1]
    for s in range(kp - 1, 0, -1):
        lists[..., s] = np.minimum(lists[..., s], np.maximum(lists[..., s - 1], x))
    lists[..., 0] = np.minimum(lists[..., 0], x)


def emulate(q, c, bias, k, wq):
    """(d2, idx) of the kernel's scheme under query tile wq."""
    b, nq, _ = q.shape
    nc = c.shape[1]
    kp = K.chunk_kp_approx(k)
    key = keys(q, c, bias)
    qb = 16 * wq
    rows_pad = -(-nq // qb) * qb
    full = np.full((b, rows_pad, nc), NONE, np.uint64)
    full[:, :nq] = key
    lists = np.full((b, rows_pad, TILE, kp), NONE, np.uint64)
    for t0 in range(0, nc, TILE):                 # tiles in index order
        insert(lists, full[:, :, t0:t0 + TILE, None][..., 0])
    own = owners(wq)
    assert len(own) == qb * TILE                  # every cell, once
    # the dump: row * (kp 128 + 8) + s 128 + col, once per slot
    pitch = kp * TILE + 8
    slots = {row * pitch + s * TILE + col for row, col in own for s in range(kp)}
    assert len(slots) == qb * kp * TILE
    d2 = np.empty((b, nq, k), np.float32)
    idx = np.empty((b, nq, k), np.int64)
    heads = np.zeros((b, rows_pad, TILE), np.int64)
    bi, qi = np.meshgrid(np.arange(b), np.arange(rows_pad), indexing="ij")
    for r in range(k):                            # k rounds over column heads
        top = np.where(heads < kp, lists[bi[..., None], qi[..., None],
                                         np.arange(TILE), np.minimum(heads, kp - 1)],
                       NONE)
        col = top.argmin(-1)
        m = np.take_along_axis(top, col[..., None], -1)[..., 0]
        np.put_along_axis(heads, col[..., None],
                          np.take_along_axis(heads, col[..., None], -1) + 1, -1)
        d2[:, :, r] = ((m[:, :nq] >> np.uint64(16)).astype(np.uint32) << 16).view(np.float32)
        idx[:, :, r] = (m[:, :nq] & np.uint64(0xFFFF)).astype(np.int64)
    return d2, idx


def _grid(n):
    g = np.stack(np.meshgrid(*[np.arange(float(n))] * 3, indexing="ij"), -1)
    return np.concatenate([g.reshape(-1, 3)] * 2).astype(np.float32)


def _case(case):
    g = np.random.default_rng(5)
    if case == "random3":
        c = (g.standard_normal((1, 4096, 3)) * 0.3).astype(np.float32)
        return c[:, :200], c, np.zeros((1, 4096), np.float32), 20, False
    if case == "random64":
        c = g.standard_normal((2, 4096, 64)).astype(np.float32)
        bias = np.zeros((2, 4096), np.float32)
        bias[:, -256:] = 1e10
        return c[:, :90], c, bias, 8, False
    if case == "random32":
        q = g.standard_normal((1, 77, 32)).astype(np.float32)
        c = g.standard_normal((1, 4224, 32)).astype(np.float32)
        return q, c, np.zeros((1, 4224), np.float32), 12, False
    if case == "random16":      # D = 16 fills one k16 step, k = 4 (kp = 2)
        c = g.standard_normal((1, 4096, 16)).astype(np.float32)
        return c[:, :50], c, np.zeros((1, 4096), np.float32), 4, False
    if case == "random33":      # D = 33 pads to 64, k = 16: the first kp = 3
        q = g.standard_normal((1, 40, 33)).astype(np.float32)
        c = g.standard_normal((1, 4096, 33)).astype(np.float32)
        return q, c, np.zeros((1, 4096), np.float32), 16, False
    if case == "k3":            # the least k the approximate mode takes
        c = (g.standard_normal((1, 4096, 3)) * 0.3).astype(np.float32)
        return c[:, :33], c, np.zeros((1, 4096), np.float32), 3, False
    if case == "k384":          # k = 128 kp: every key of every list
        c = (g.standard_normal((1, 4096, 3)) * 0.3).astype(np.float32)
        return c[:, :17], c, np.zeros((1, 4096), np.float32), 384, False
    if case == "grid":          # a 16^3 grid twice: exact ties, bit for bit
        pts = _grid(16)[None]
        return pts[:, ::41], pts, np.zeros((1, 8192), np.float32), 20, True
    if case == "sentinel":      # a padded frame: sentinel rows tie at d2 = 0
        c = (g.standard_normal((1, 4224, 3)) * 0.3).astype(np.float32)
        c[:, -112:] = PAD_SENTINEL
        q = np.concatenate([c[:, :40], c[:, -60:]], 1)
        return q, c, np.zeros((1, 4224), np.float32), 20, "sentinel"
    if case == "dropped":       # chip_smoke's column-overflow query
        drng = np.random.default_rng(3)
        dirs = drng.standard_normal((4096, 3))
        cand = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * drng.uniform(
            2.0, 3.0, (4096, 1))
        for i, r in ((5, 0.125), (133, 0.25), (261, 0.375), (7, 0.5)):
            cand[i] = (r, 0.0, 0.0)
        return (np.zeros((1, 1, 3), np.float32), cand[None].astype(np.float32),
                np.zeros((1, 4096), np.float32), 4, True)
    raise ValueError(case)


@pytest.mark.parametrize("wq", sorted(K.APPROX_BLOCKS_PER_SM))
@pytest.mark.parametrize("case", ["random3", "random64", "random32",
                                  "random16", "random33", "k3", "k384",
                                  "grid", "sentinel", "dropped"])
def test_emulated_kernel_matches_plain(case, wq):
    q, c, bias, k, exact = _case(case)
    got = emulate(q, c, bias, k, wq)
    T = torch.from_numpy
    want = K.knn_approx_plain(T(q), T(c), T(bias), k)
    if case == "sentinel":      # the last 60 queries sit at the sentinel
        np.testing.assert_array_equal(got[0][:, 40:], want[0][:, 40:].numpy())
        np.testing.assert_array_equal(got[1][:, 40:], want[1][:, 40:].numpy())
        got, want = (got[0][:, :40], got[1][:, :40]), (want[0][:, :40], want[1][:, :40])
        q, c, bias = q[:, :40], c[:, :-112], bias[:, :-112]
        assert int(got[1].max()) < c.shape[1]
    if exact is True:
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
        if case == "dropped":   # 261 (lane column 5's third) is dropped
            assert got[1][0, 0].tolist()[:3] == [5, 133, 7]
        return
    a = K.approx_agreement(tuple(T(np.asarray(x)) for x in got),
                           tuple(torch.as_tensor(x) for x in want),
                           (T(q), T(c), T(bias)))
    assert a["d2_excess"] <= 0 and a["d2_unexplained"] == 0, a
    assert a["rows_unexplained"] == 0 and a["rows"] <= 0.02 * a["queries"], a


@pytest.mark.parametrize("d", [3, 32, 64])
def test_k16_steps_of_bf16_operands_stay_within_the_tolerance(d):
    """The cross term in k16 steps of f32 partial sums against the float64
    product of the same bf16 operands: well inside approx_agreement's tol =
    1e-5 x 2 max |p|^2 (the tensor cores add a step's products in another
    order still, with errors of the same size)."""
    g = np.random.default_rng(d)
    x = g.standard_normal((1, 512, d)).astype(np.float32)
    xh, _ = prep(x, K.approx_dk(d))
    got = cross_term(xh, xh).astype(np.float64)
    exact = np.einsum("bqd,bcd->bqc", xh.astype(np.float64), xh.astype(np.float64))
    tol = 1e-5 * 2 * float((x.astype(np.float64) ** 2).sum(-1).max())
    assert float(np.abs(2 * (got - exact)).max()) <= 0.05 * tol
