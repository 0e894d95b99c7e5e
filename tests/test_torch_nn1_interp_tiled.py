"""The launch plans of the nn1 and dense interp kernels (``csrc/nn1.cu``,
``csrc/interp.cu``) and the two exactness arguments their designs rest on.

* ``nn1_plan`` and ``interp_plan`` at every row of ``chip_smoke.NN1_SHAPES``,
  at the train step's interp call and at edge sizes (Nq = 1, M = 1, B = 0,
  M below a chunk and below a tile): the blocks' query slots cover Nq with
  fewer idle slots than one warp a block holds, the splits cover the
  candidates once with none empty, and the main paths' launches fill the
  card with at least two blocks an SM; out-of-range shapes are refused.
* A numpy emulation of ``nn1.cu``'s selection: within a split the running
  minimum of |c|^2 + bias - 2 q.c (three FMAs a pair) by chunk, the chunk in
  which it last fell strictly, the first index in that chunk that attains
  it, the winner's d2 by the contract's formula, then the least (d2, index)
  key over the splits. Under several plans it equals the first argmin
  (``nn1_plain``) bit for bit on lattice ties, duplicated points, a fully
  masked row and sentinel rows, whose arithmetic is exact, and gives a
  query with a NaN coordinate NaN and index 0 as ``nn1_plain`` does.
* ``nn1_plain`` against the Pallas kernel ``nn1_pallas`` (interpret mode) on
  exact ties.
* A numpy f32 emulation of ``interp.cu``'s sums: every kind's weight is +0
  wherever the kernel's test d2 > ``d2_threshold`` finds u > 1 (masked
  candidates, sentinel queries, pairs just past the cutoff), so the sums
  with those pairs skipped equal the full sums bit for bit; pairs at
  exactly u = 1 are kept (the exponential kind weighs them); the threshold
  is the last d2 whose rounded u is at most 1.
* ``interp_plain`` against ``kernel_interp_pallas`` (interpret mode) at the
  plan's edge sizes.

On the card ``tests/test_torch_port.py`` (marked gpu) runs each kernel
under several plans against its plain version.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.ops.pallas.interp_kernel import kernel_interp_pallas
from tpugan_tpu.ops.pallas.nn1_kernel import nn1_pallas
from tpugan_tpu_torch.ops.kernels import interp as I
from tpugan_tpu_torch.ops.kernels import nn1 as N1

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import NN1_SHAPES  # noqa: E402

BIG = np.float32(1e10)
SMS = 132


# ---------------------------------------------------------------- the plans

def _assert_cover(plan, b, nq, m):
    """Query slots cover Nq with fewer idle slots than 32 a thread-slot
    column of every block; the splits cover [0, M) once, none empty."""
    qb = plan.q_blocks(nq)
    slots = qb * plan.queries
    assert nq <= slots < nq + qb * 32 * (plan.queries // plan.threads)
    starts = np.arange(plan.splits) * plan.span
    ends = np.minimum(starts + plan.span, m)
    assert starts[0] == 0 and ends[-1] == m and np.all(ends > starts)
    assert np.all(starts[1:] == ends[:-1])
    assert plan.blocks(b, nq) == b * plan.splits * qb


NN1_PLAN_CASES = sorted({(b, nq, m) for _, b, nq, m, *_ in NN1_SHAPES})


@pytest.mark.parametrize("b,nq,m", NN1_PLAN_CASES)
def test_nn1_plan_fills_the_card_at_the_main_shapes(b, nq, m):
    plan = N1.nn1_plan(b, nq, m, SMS)
    assert plan.admits(nq, m)
    _assert_cover(plan, b, nq, m)
    assert plan.blocks(b, nq) >= 1.9 * SMS         # about two blocks an SM
    assert plan.span >= N1.MIN_SPAN and plan.queries == N1.QPT * plan.threads


@pytest.mark.parametrize("b,nq,m", [(1, 1, 1), (1, 1, 777), (3, 300, 1),
                                    (0, 5, 5), (2, 33, 31), (1, 2000, 100),
                                    (5, 70, 1023), (1, 81920, 33)])
def test_nn1_plan_covers_edge_sizes(b, nq, m):
    plan = N1.nn1_plan(b, nq, m, SMS)
    assert plan.admits(max(nq, 1), m)
    _assert_cover(plan, b, max(nq, 1), m)
    assert plan.span % N1.CHUNK == 0


@pytest.mark.parametrize("b,nq,m", [(-1, 5, 5), (1, 5, 0), (2 ** 16, 2 ** 15, 5),
                                    (1, 5, 2 ** 31)])
def test_nn1_plan_refuses_out_of_range_shapes(b, nq, m):
    with pytest.raises(ValueError):
        N1.nn1_plan(b, nq, m, SMS)
    with pytest.raises(ValueError):
        N1.nn1_plan(1, 5, 5, 0)                     # a card without SMs


@pytest.mark.parametrize("plan", [
    N1.Nn1Plan(128, 2, 48),          # span off the chunk
    N1.Nn1Plan(128, 4, 32),          # an empty split at M = 90
    N1.Nn1Plan(128, 2, 32),          # M = 90 not covered
    N1.Nn1Plan(128, 1, 16),          # a span shorter than a chunk
    N1.Nn1Plan(48, 3, 32),           # threads off the warp
    N1.Nn1Plan(512, 3, 32),          # more threads than the kernel takes
])
def test_nn1_plan_admits_only_the_kernels_shapes(plan):
    assert not plan.admits(100, 90)
    assert N1.Nn1Plan(128, 3, 32).admits(100, 90)


INTERP_PLAN_CASES = [(12, 9216, 9216, 3), (1, 80000, 80000, 1),
                     (1, 32768, 80000, 1), (2, 700, 1100, 5)]


@pytest.mark.parametrize("b,nq,m,c", INTERP_PLAN_CASES)
def test_interp_plan_fills_the_card_at_its_shapes(b, nq, m, c):
    plan = I.interp_plan(b, nq, m, c)
    assert plan.admits(nq, m, c) and plan.queries == I.QPT * plan.threads
    _assert_cover(plan, b, nq, m)
    if b * nq >= 9216:
        assert plan.blocks(b, nq) >= 2 * SMS
        assert plan.span <= max(I.SPAN, 32 * -(-m // (32 * I.MAX_SPLITS)))


@pytest.mark.parametrize("b,nq,m,c", [(1, 1, 1, 1), (0, 5, 5, 3), (2, 33, 31, 8),
                                      (3, 300, 1, 2), (1, 1, 4000, 4)])
def test_interp_plan_covers_edge_sizes(b, nq, m, c):
    plan = I.interp_plan(b, nq, m, c)
    assert plan.admits(max(nq, 1), m, c)
    assert plan.queries == I.QPT * plan.threads
    _assert_cover(plan, b, max(nq, 1), m)


@pytest.mark.parametrize("b,nq,m,c", [(1, 5, 5, 0), (1, 5, 5, 9), (1, 5, 0, 3),
                                      (-1, 5, 5, 3)])
def test_interp_plan_refuses_out_of_range_shapes(b, nq, m, c):
    with pytest.raises(ValueError):
        I.interp_plan(b, nq, m, c)
    assert not I.InterpPlan(128, 1, 8).admits(5, 8, 9)      # C over 8


# ------------------------------------------------- nn1: the selection in numpy

def fma32(a, b, c):
    """f32 fma of f32 arrays; exact wherever a*b + c fits a float64 (the
    tests' lattice inputs), so there it is the correctly rounded fma."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def pair_values(q, c, bias):
    """nn1.cu's cand_row and pair_value: [Nq, M] of |c|^2 + bias - 2 q.c."""
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    c2 = fma32(z, z, fma32(y, y, x * x))
    w = (c2.astype(np.float64) + bias).astype(np.float32)
    rows = [-2 * x, -2 * y, -2 * z]
    return fma32(rows[0][None], q[:, :1], fma32(rows[1][None], q[:, 1:2],
                 fma32(rows[2][None], q[:, 2:3], w[None])))


def winner_d2(q, c, bias):
    """nn1.cu's winner_d2 for paired rows q [n, 3], c [n, 3], bias [n]."""
    q2 = fma32(q[:, 2], q[:, 2], fma32(q[:, 1], q[:, 1], q[:, 0] * q[:, 0]))
    c2 = fma32(c[:, 2], c[:, 2], fma32(c[:, 1], c[:, 1], c[:, 0] * c[:, 0]))
    dot = fma32(q[:, 0], c[:, 0], fma32(q[:, 1], c[:, 1], q[:, 2] * c[:, 2]))
    return (np.maximum(fma32(np.float32(-2), dot, q2 + c2), np.float32(0))
            .astype(np.float64) + bias).astype(np.float32)


def emulate_nn1(q, c, bias, plan):
    """(d2, idx) of one row as nn1.cu selects them under ``plan``."""
    nq, m = q.shape[0], c.shape[0]
    vals = pair_values(q, c, bias)
    vals[np.isnan(vals)] = np.inf            # fminf passes over a NaN
    best_d = np.full(nq, np.inf, np.float32)
    best_i = np.full(nq, -1, np.int64)       # the key before any merge
    for s in range(plan.splits):
        lo, hi = s * plan.span, min(m, (s + 1) * plan.span)
        v = vals[:, lo:hi]
        n_chunks = -(-(hi - lo) // N1.CHUNK)
        padded = np.full((nq, n_chunks * N1.CHUNK), np.inf, np.float32)
        padded[:, :hi - lo] = v
        chunk_min = padded.reshape(nq, n_chunks, N1.CHUNK).min(-1)
        running = np.minimum.accumulate(chunk_min, axis=1)
        before = np.concatenate([np.full((nq, 1), np.inf, np.float32),
                                 running[:, :-1]], 1)
        fell = running < before
        last = n_chunks - 1 - np.argmax(fell[:, ::-1], axis=1)
        best = running[:, -1]
        win = np.full(nq, lo, np.int64)          # no value below +inf
        for i in np.flatnonzero(fell.any(1)):
            start = last[i] * N1.CHUNK
            chunk = padded[i, start:start + N1.CHUNK]
            win[i] = lo + start + int(np.flatnonzero(chunk == best[i])[0])
        d = winner_d2(q, c[win], bias[win])
        # the 64-bit key: d2's order with NaN after every number, then index
        nan_d, nan_b = np.isnan(d), np.isnan(best_d)
        d_, b_ = np.where(nan_d, np.inf, d), np.where(nan_b, np.inf, best_d)
        take = (best_i < 0) | (nan_d < nan_b) | ((nan_d == nan_b) & (
            (d_ < b_) | ((d_ == b_) & (win < best_i))))
        best_d = np.where(take, d, best_d)
        best_i = np.where(take, win, best_i)
    return best_d, best_i


def _lattice(gen, n, span=8):
    return (gen.integers(-span, span + 1, (n, 3)) * 0.25).astype(np.float32)


def _nn1_case(gen, case):
    """(query [B, Nq, 3], cand [B, M, 3], bias [B, M]) whose arithmetic is
    exact in f32: lattice points at multiples of 0.25."""
    if case == "lattice":
        return _lattice(gen, 300)[None], _lattice(gen, 700)[None], \
            np.zeros((1, 700), np.float32)
    if case == "duplicated":
        c = _lattice(gen, 200)
        c = np.concatenate([c, c, c])[gen.permutation(600)]
        return c[None, ::2].copy(), c[None], np.zeros((1, 600), np.float32)
    if case == "masked":
        q, c = _lattice(gen, 250), _lattice(gen, 400)
        bias = np.zeros((2, 400), np.float32)
        bias[0, -100:] = BIG
        bias[1] = BIG                                   # a row all masked
        return np.stack([q, q]), np.stack([c, c]), bias
    if case == "sentinel":
        q = _lattice(gen, 260)
        q[-60:] = 999.0
        return q[None], _lattice(gen, 500)[None], np.zeros((1, 500), np.float32)
    if case == "nan_query":                             # a diverged output
        q = _lattice(gen, 260)
        q[7] = np.nan
        q[100:103, 1] = np.nan
        return q[None], _lattice(gen, 500)[None], np.zeros((1, 500), np.float32)
    raise ValueError(case)


def _emulated_plans(b, nq, m):
    chunk = N1.CHUNK
    third = chunk * -(-m // (3 * chunk))
    return [N1.nn1_plan(b, nq, m, SMS), N1.Nn1Plan(32, -(-m // chunk), chunk),
            N1.Nn1Plan(256, 1, chunk * -(-m // chunk)),
            N1.Nn1Plan(64, -(-m // third), third)]


@pytest.mark.parametrize("variant", range(4))
@pytest.mark.parametrize("case", ["lattice", "duplicated", "masked",
                                  "sentinel", "nan_query"])
def test_nn1_split_chunk_rescan_selection_is_the_first_argmin(case, variant):
    gen = np.random.default_rng(3)
    q, c, bias = _nn1_case(gen, case)
    b, nq, m = q.shape[0], q.shape[1], c.shape[1]
    plan = _emulated_plans(b, nq, m)[variant]
    assert plan.admits(nq, m)
    want_d, want_i = N1.nn1_plain(torch.from_numpy(q), torch.from_numpy(c),
                                  torch.from_numpy(bias))
    for row in range(b):
        d, i = emulate_nn1(q[row], c[row], bias[row], plan)
        np.testing.assert_array_equal(i, want_i[row].numpy())
        np.testing.assert_array_equal(d, want_d[row].numpy())
    if case == "masked":
        assert (want_i[1] == 0).all()             # every candidate ties at BIG
        assert (bias[0][want_i[0].numpy()] == 0).all()
    if case == "nan_query":                       # NaN and the first index
        nan = np.isnan(q[0]).any(-1)
        assert np.isnan(want_d[0].numpy()[nan]).all()
        assert (want_i[0].numpy()[nan] == 0).all()


@pytest.mark.parametrize("case", ["lattice", "duplicated"])
def test_nn1_plain_matches_pallas_on_exact_ties(case):
    gen = np.random.default_rng(5)
    q, c, bias = _nn1_case(gen, case)
    d_t, i_t = N1.nn1_plain(torch.from_numpy(q), torch.from_numpy(c),
                            torch.from_numpy(bias))
    d_j, i_j = nn1_pallas(jnp.asarray(q), jnp.asarray(c), jnp.asarray(bias))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


# --------------------------------------------- interp: the skip is exact

def weights32(d2, cutoff, kind):
    """sph_weight.cuh's weight in f32, every operation rounded on its own."""
    inv_c2, k1, k2 = (np.float32(x) for x in I.kernel_constants(cutoff, kind))
    u = np.maximum(d2 * inv_c2, np.float32(0))
    q = np.sqrt(u)
    one, half, zero = np.float32(1), np.float32(0.5), np.float32(0)
    if kind == "linear":
        return np.maximum(one - q, zero)
    if kind == "exponential":
        return np.where(u <= one, k1 * np.exp(-u), zero).astype(np.float32)
    s1, s2 = np.maximum(one - q, zero), np.maximum(half - q, zero)
    return k1 * (s1 * s1 * s1) - k2 * (s2 * s2 * s2)


def sums32(w, vals, keep):
    """The kernel's sums over the candidates in order: den += w, num =
    fma(w, v, num), each pair only where ``keep``."""
    nq, m = w.shape
    den = np.zeros(nq, np.float32)
    num = np.zeros((nq, vals.shape[1]), np.float32)
    for j in range(m):
        k = keep[:, j]
        den[k] = den[k] + w[k, j]
        num[k] = fma32(w[k, j][:, None], vals[j][None], num[k])
    return num, den


@pytest.mark.parametrize("cutoff", [0.16, 0.5])
@pytest.mark.parametrize("kind", sorted(I.KINDS))
def test_interp_skip_of_far_pairs_is_bit_exact(kind, cutoff):
    """Three candidates at exactly the cutoff from query 0 (u = 1 where the
    cutoff is dyadic) and one a float past it, 20% masked candidates and 6
    sentinel queries among random ones."""
    gen = np.random.default_rng(11)
    q = (gen.standard_normal((90, 3)) * 0.3).astype(np.float32)
    c = (gen.standard_normal((160, 3)) * 0.3).astype(np.float32)
    q[-6:] = 999.0                                 # sentinel queries
    q[0] = 0.0                                     # pairs at exactly u = 1 ...
    c[:3] = np.float32(cutoff) * np.eye(3, dtype=np.float32)
    c[3] = (np.nextafter(np.float32(cutoff), np.float32(1)), 0, 0)  # ... and past
    vals = gen.standard_normal((160, 4)).astype(np.float32)
    bias = np.where(gen.random(160) < 0.2, BIG, np.float32(0)).astype(np.float32)
    bias[:4] = 0
    d = q[:, None] - c[None]
    d2 = (((d[..., 0] * d[..., 0]) + (d[..., 1] * d[..., 1]))
          + (d[..., 2] * d[..., 2])) + bias[None]
    inv_c2 = np.float32(I.kernel_constants(cutoff, kind)[0])
    near = ~(d2 > np.float32(I.d2_threshold(cutoff)))    # the kernel's test
    assert np.array_equal(near, ~(d2 * inv_c2 > 1))      # u <= 1
    w = weights32(d2, cutoff, kind)
    far = w[~near]
    assert far.size and (far == 0).all() and not np.signbit(far).any()
    assert not near[0, 3]
    if cutoff == 0.5:                              # d2 / cutoff^2 exact: u = 1
        assert near[0, :3].all()
        assert ((w[0, :3] > 0) == (kind == "exponential")).all()
    num_all, den_all = sums32(w, vals, np.ones_like(near))
    num_skip, den_skip = sums32(w, vals, near)
    assert np.array_equal(num_all.view(np.int32), num_skip.view(np.int32))
    assert np.array_equal(den_all.view(np.int32), den_skip.view(np.int32))
    out, den = I.interp_plain(*(torch.from_numpy(a)[None] for a in (q, c, vals)),
                              cutoff, torch.from_numpy(bias)[None], kind)
    np.testing.assert_allclose(den[0].numpy(), den_all + np.float32(1e-6),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out[0].numpy(),
                               num_all / (den_all + np.float32(1e-6))[:, None],
                               rtol=0, atol=1e-5 * np.abs(vals).max())


@pytest.mark.parametrize("cutoff", [0.16, 0.05, 0.5, 1.0 / 3.0, 1e-3, 7.5])
def test_d2_threshold_is_the_last_d2_with_u_at_most_one(cutoff):
    """d2 <= d2_threshold exactly where d2 * (1 / cutoff^2) rounds to at
    most 1, over the 4,001 floats around the threshold and random ones."""
    t = np.float32(I.d2_threshold(cutoff))
    inv = np.float32(I.kernel_constants(cutoff, "bicubic")[0])
    around = t.view(np.int32) + np.arange(-2000, 2001, dtype=np.int32)
    d2 = np.concatenate([around.view(np.float32),
                         np.random.default_rng(0).random(1000, np.float32)
                         * np.float32(4 * cutoff * cutoff)])
    assert np.array_equal(d2 <= t, d2 * inv <= np.float32(1))


@pytest.mark.parametrize("b,nq,m,c", [(1, 1, 1, 1), (2, 33, 31, 8),
                                      (1, 129, 600, 3), (3, 70, 97, 2)])
def test_interp_plain_matches_pallas_at_plan_edges(b, nq, m, c):
    gen = np.random.default_rng(13)
    q = (gen.standard_normal((b, nq, 3)) * 0.3).astype(np.float32)
    cand = (gen.standard_normal((b, m, 3)) * 0.3).astype(np.float32)
    q[:, -1] = 999.0 if nq > 1 else q[:, -1]
    vals = gen.standard_normal((b, m, c)).astype(np.float32)
    bias = np.where(gen.random((b, m)) < 0.2, BIG, np.float32(0)).astype(np.float32)
    if m == 1:
        cand[:] = q[:, :1]                        # one candidate, within reach
        bias[:] = 0
    assert I.interp_plan(b, nq, m, c).admits(nq, m, c)
    out_j, den_j = kernel_interp_pallas(jnp.asarray(q), jnp.asarray(cand),
                                        jnp.asarray(vals), 0.5,
                                        jnp.asarray(bias), kind="bicubic")
    out_t, den_t = I.interp_plain(*(torch.from_numpy(a) for a in (q, cand, vals)),
                                  0.5, torch.from_numpy(bias), "bicubic")
    den_j = np.asarray(den_j)
    np.testing.assert_allclose(den_t.numpy(), den_j, rtol=1e-5,
                               atol=1e-5 * np.abs(den_j).max())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-5 * np.abs(vals).max())
