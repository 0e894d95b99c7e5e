"""The redesigned f32 fused-EdgeConv backward at EdgeConv_0's (6, 64, 128),
the action generator's EdgeConv_0 (3, 64, 128), the IDGCN's (32, 16, 32)
and the mask head's sum class (64, 128, 128, no SharedMLP): its oracle
against the JAX package, its scheme emulated in numpy, and its launch
plan.

* ``edgeconv_backward_plain`` (the card kernel's oracle) against the Pallas
  backward ``_bwd_pallas`` run in interpret mode at each class's widths,
  N = 16 (a multiple of 8, so the Pallas body runs): the class's own k and
  aggregate, every other aggregate, and a table whose duplicated planes
  tie exactly at the max.
* The scheme (``csrc/edgeconv.cu`` : bwdt, rowf): the sign words that
  ``store_signs`` writes at 64- and 128-column tiles (a warp's ballot) read
  back each slope through ``slope_of`` and ``sign_at``, and the IDGCN's
  16-bit masks theirs; C = 6 or 3 padded to an 8-deep slab with zeros
  leaves every product as it is, and the narrow tail's threads own every
  gnbr, dWn and dWe entry once; the tie pass without the SharedMLP (``bwd_ties_h1``: y = h1, slopes
  from the words) gives the plain version's gradients bit for bit; the
  row-fused kernel's lanes own every dW entry once, its blocks every tile
  once, and its row formulas give the plain version's gradients.
* ``tiled_bwd_plan`` at each class: ranges, partials, scratch, blocks,
  the 32-bit refusal, and no plan outside the classes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.ops.pallas.edgeconv_kernel import _bwd_pallas
from tpugan_tpu_torch.ops.kernels import edgeconv as E

EC0, IDGCN, MSUM = (True, 6, 64, 128), (True, 32, 16, 32), (False, 64, 128, 128)
EC0_ACTION = E.ACTION_EC0_CLASS   # (True, 3, 64, 128)


def _inputs(rng, cls, b, k, n, ties):
    mlp, c, h, o = cls
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    nbr = f(b, k, n, c)
    if ties:
        nbr[:, 1], nbr[:, 5] = nbr[:, 0], nbr[:, 3]
    return (nbr, f(b, n, c), f(c, h, sc=c ** -0.5), f(c, h, sc=c ** -0.5),
            f(h, h, sc=h ** -0.5) if mlp else None,
            f(h, o, sc=h ** -0.5) if mlp else None, f(b, n, o))


@pytest.mark.parametrize("cls,k,agg,ties", [
    (EC0, 20, "max", False), (EC0, 20, "min", False), (EC0, 20, "sum", False),
    (EC0, 20, "mean", False), (EC0, 20, "max", True),
    (EC0_ACTION, 20, "max", False), (EC0_ACTION, 20, "min", False),
    (EC0_ACTION, 20, "sum", False), (EC0_ACTION, 20, "mean", False),
    (EC0_ACTION, 20, "max", True),
    (IDGCN, 20, "max", False), (IDGCN, 10, "max", False),
    (IDGCN, 10, "min", False), (IDGCN, 10, "sum", False),
    (IDGCN, 10, "mean", False), (IDGCN, 10, "max", True),
    (MSUM, 8, "sum", False), (MSUM, 8, "max", False), (MSUM, 8, "min", False),
    (MSUM, 8, "mean", False), (MSUM, 8, "max", True)])
def test_plain_backward_matches_pallas_at_new_class(rng, cls, k, agg, ties):
    """f32 to the 3e-5 of tests/test_torch_edgeconv_bwd_tiled.py (summation
    order); tied planes split every cotangent they share evenly."""
    args = _inputs(rng, cls, 1, k, 16, ties)
    J = lambda a: None if a is None else jnp.asarray(a)
    want = _bwd_pallas(*(J(a) for a in args), aggregate=agg, cdt=jnp.float32)
    assert want is not None                      # the Pallas body ran
    got = E.edgeconv_backward_plain(
        *(None if a is None else torch.from_numpy(a) for a in args), agg)
    for i, (a, w) in enumerate(zip(got, want)):
        if w is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=3e-5,
                                   atol=3e-5, err_msg=f"gradient {i}")
    if ties:
        assert torch.equal(got[0][:, 1], got[0][:, 0])
        assert torch.equal(got[0][:, 5], got[0][:, 3])
        assert float(got[0][:, 0].abs().max()) > 0


# ------------------------------------------------------- the scheme in numpy

BM = 128   # rows of a row product's tile (bwdt::BM)


def _tile_rc(t, i, j):
    """(row, column) of thread t's accumulator (i, j) (gemm_tile.cuh : Tile)."""
    ty, tx = divmod(t, 16)
    return (i // 4) * 64 + ty * 4 + i % 4, (j // 4) * 64 + tx * 4 + j % 4


def store_signs(z):
    """bwdt::store_signs over a [BM, BN] tile of pre-activations: each warp's
    ballot of z >= 0 per accumulator, lanes 0 and 16 writing their half ->
    [BM, BN / 32] words."""
    bn = z.shape[1]
    tn = bn // 16
    words = np.zeros((BM, tn // 2), np.uint64)
    for w in range(8):
        for i in range(BM // 16):
            for j in range(tn):
                ballot = 0
                for lane in range(32):
                    r, c = _tile_rc(32 * w + lane, i, j)
                    ballot |= int(z[r, c] >= 0) << lane
                for lane in (0, 16):
                    r, _ = _tile_rc(32 * w + lane, i, j)
                    b = (ballot >> (lane & 16)) & 0xFFFF
                    words[r, j // 2] |= np.uint64(b << (16 * (j % 2)))
    return words.astype(np.uint32)


def slope_of(words_row, j, tx):
    return 1.0 if (int(words_row[j // 2]) >> (16 * (j % 2) + tx)) & 1 else 0.2


def sign_at(words_row, col):
    u = col % 4
    return bool((int(words_row[2 * (col // 64) + u // 2])
                 >> (16 * (u % 2) + (col % 64) // 4)) & 1)


def _signed_tile(rng, bn):
    z = rng.standard_normal((BM, bn)).astype(np.float32)
    z[rng.random(z.shape) < 0.05] = 0.0
    z[rng.random(z.shape) < 0.05] = -0.0         # -0 >= 0, slope 1
    return z


@pytest.mark.parametrize("bn", [64, 128])
def test_sign_words_read_back_every_slope(rng, bn):
    """At H = 64 (2 words a layer) and H = 128 (4): every thread's slope_of
    and every column's sign_at give lrelu'(z) of the tile's own entry."""
    z = _signed_tile(rng, bn)
    words = store_signs(z)
    assert words.shape == (BM, bn // 32)
    want = np.where(z >= 0, 1.0, 0.2)
    for t in range(256):
        for i in range(BM // 16):
            for j in range(bn // 16):
                r, c = _tile_rc(t, i, j)
                assert slope_of(words[r], j, t % 16) == want[r, c]
    got = np.array([[1.0 if sign_at(words[r], c) else 0.2 for c in range(bn)]
                    for r in range(BM)])
    np.testing.assert_array_equal(got, want)


def test_idgcn_sign_masks_read_back_every_slope(rng):
    """The row-fused kernel's 16-bit masks (rowf::forward_row, slope)."""
    z = _signed_tile(rng, 16)
    masks = [sum(int(v >= 0) << h for h, v in enumerate(row)) for row in z]
    got = np.array([[1.0 if (m >> h) & 1 else 0.2 for h in range(16)]
                    for m in masks])
    np.testing.assert_array_equal(got, np.where(z >= 0, 1.0, 0.2))


def _fma_chain(x, w):
    """acc = fmaf(x[:, c], w[c], acc) over c ascending, from 0 (the product's
    chains; each step's product exact in f64, its sum rounded to f32)."""
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for c in range(x.shape[1]):
        acc = (x[:, c:c + 1].astype(np.float64) * w[c].astype(np.float64)
               + acc).astype(np.float32)
    return acc


@pytest.mark.parametrize("c", [6, 3])
def test_six_channels_padded_to_a_slab_are_exact(rng, c):
    """EdgeConv_0 (C = 6) and the action generator's (C = 3): a slab
    zero-fills the channels past C of the rows and the weight rows past C
    (Slab::copy), so z1a over depth 8 equals z1a over depth C bit for bit;
    the narrow tail (bwd_narrow) writes gnbr's [nr, C] outputs of a tile
    once each, one thread an output (row, c)."""
    x, w = rng.standard_normal((40, c)).astype(np.float32), \
        rng.standard_normal((c, 64)).astype(np.float32)
    xp, wp = np.zeros((40, 8), np.float32), np.zeros((8, 64), np.float32)
    xp[:, :c], wp[:c] = x, w
    np.testing.assert_array_equal(_fma_chain(xp, wp), _fma_chain(x, w))
    rows = 3080
    seen = np.zeros(rows * c, int)
    for tile in range(-(-rows // E.NARROW_TILE)):
        r0 = tile * E.NARROW_TILE
        nr = min(E.NARROW_TILE, rows - r0)
        for t in range(256):
            for e in range(t, nr * c, 256):
                row, ch = divmod(e, c)
                assert r0 * c + e == (r0 + row) * c + ch
                seen[r0 * c + e] += 1
    assert (seen == 1).all()


def _words_of(z):
    """Sign words of z [R, H] over BM-row tiles, as bwd_rows writes them."""
    r = z.shape[0]
    pad = np.zeros((-(-r // BM) * BM, z.shape[1]), np.float32)
    pad[:r] = z
    return np.concatenate([store_signs(pad[m:m + BM])
                           for m in range(0, pad.shape[0], BM)])[:r]


@pytest.mark.parametrize("agg", ["max", "min", "sum", "mean"])
def test_no_mlp_tie_pass_gives_plain_gradients(rng, agg):
    """bwd_ties_h1 emulated over the stored h1 and sign words (y = h1 itself,
    the count from the stored values, d1a = gy lrelu'(z1a), d1b = gy
    lrelu'(z1b)): the gradients that follow equal the plain version's bit
    for bit, duplicated planes splitting their cotangent."""
    b, k, n, c, h = 2, 8, 12, 64, 128
    nbr, ctr, wn, we, _, _, g = _inputs(rng, MSUM, b, k, n, True)
    T = torch.from_numpy
    _, edge, z1a, z1b, h1, *_ = E._layers(T(nbr), T(ctr), T(wn), T(we), None,
                                          None, torch.float32)
    rows = b * k * n
    words = np.concatenate([_words_of(z1a.reshape(rows, h).numpy()),
                            _words_of(z1b.reshape(rows, h).numpy())], 1)
    y = h1.reshape(rows, h).numpy()
    d1a = np.empty_like(y)
    d1b = np.empty_like(y)
    for p in range(b * n):
        bb, nn = divmod(p, n)
        rs = [(bb * k + j) * n + nn for j in range(k)]
        gy = g[bb, nn].copy()
        if agg == "mean":
            gy = (gy / np.float32(k)).astype(np.float32)
        acc, cnt = y[rs[0]].copy(), np.ones(h, np.float32)
        for r in rs[1:]:
            beyond = y[r] > acc if agg == "max" else y[r] < acc
            same = y[r] == acc
            acc = np.where(beyond, y[r], acc)
            cnt = np.where(beyond, 1.0, np.where(same, cnt + 1, cnt)).astype(
                np.float32)
        for r in rs:
            gu = (np.where(y[r] == acc, gy, 0.0).astype(np.float32) / cnt
                  if agg in ("max", "min") else gy)
            sa = np.array([1.0 if sign_at(words[r, :4], col) else 0.2
                           for col in range(h)], np.float32)
            sb = np.array([1.0 if sign_at(words[r, 4:], col) else 0.2
                           for col in range(h)], np.float32)
            d1a[r], d1b[r] = gu * sa, gu * sb
    d1a, d1b = T(d1a).reshape(b, k, n, h), T(d1b).reshape(b, k, n, h)
    gnb_b = d1b @ T(we).t()
    got = (d1a @ T(wn).t() + gnb_b, -gnb_b.sum(1),
           torch.einsum("bknc,bknh->ch", T(nbr), d1a),
           torch.einsum("bknc,bknh->ch", edge, d1b))
    want = E.edgeconv_backward_plain(T(nbr), T(ctr), T(wn), T(we), None, None,
                                     T(g), agg)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert torch.equal(want[0][:, 1], want[0][:, 0])


# the row-fused kernel's dW lanes (rowf_bwd): warp -> (first float of its
# product in the packed partials, its row length, lane -> (mg, ng), lanes)
ROWF_C, ROWF_H, ROWF_O = 32, 16, 32
WN, WE = 0, ROWF_C * ROWF_H
W1, W2 = 2 * ROWF_C * ROWF_H, 2 * ROWF_C * ROWF_H + ROWF_H * ROWF_H
ROWF_LANES = {0: (WN, ROWF_H, lambda l: (l // 4, l % 4), range(32)),
              1: (WE, ROWF_H, lambda l: (l // 4, l % 4), range(32)),
              2: (W1, ROWF_H, lambda l: ((l % 16) // 4, l % 4), range(16)),
              3: (W2, ROWF_O, lambda l: (l // 8, l % 8), range(32))}


def test_row_fused_lanes_own_every_dw_entry_once():
    """Each lane's 4 x 4 block lies inside its warp's product, and the 112
    blocks cover the 1,792 packed partials (dWn, dWe, dW1, dW2) once."""
    seen = np.zeros(E.ROWF_PART, int)
    extent = {0: (ROWF_C, ROWF_H), 1: (ROWF_C, ROWF_H), 2: (ROWF_H, ROWF_H),
              3: (ROWF_H, ROWF_O)}
    for warp, (out0, ldw, mn, lanes) in ROWF_LANES.items():
        for lane in lanes:
            mg, ng = mn(lane)
            for a in range(4):
                for b in range(4):
                    m, nn = 4 * mg + a, 4 * ng + b
                    assert m < extent[warp][0] and nn < extent[warp][1]
                    seen[out0 + m * ldw + nn] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("rows", [1, 127, 3080, 276480])
def test_row_fused_blocks_take_every_tile_once(rows):
    """Block i walks tiles i, i + blocks, ... (rowf_bwd): every tile once,
    each block's tiles ascending, the partials summed in block order."""
    plan = E.tiled_bwd_plan(1, 1, rows, IDGCN)
    tiles, blocks = plan["row_tiles"], plan["blocks"]
    taken = [t for blk in range(blocks) for t in range(blk, tiles, blocks)]
    assert sorted(taken) == list(range(tiles))
    assert blocks <= E.ROWF_BLOCKS and blocks <= tiles


def test_row_fused_formulas_give_plain_gradients(rng):
    """One plane-row a thread, as rowf_bwd computes it (z3 from rowf_fwd,
    d3 from the tie pass, the slopes as masks, gb = d1b We^T, gnbr = d1a
    Wn^T + gb; dW over each block's tiles in order, then the blocks in
    order): the plain version's gradients to 3e-5."""
    b, k, n = 2, 10, 13
    args = _inputs(rng, IDGCN, b, k, n, True)
    nbr, ctr, wn, we, w1, w2, g = (a.astype(np.float64) for a in args)
    lr = lambda z: np.where(z >= 0, z, 0.2 * z)
    sl = lambda z: np.where(z >= 0, 1.0, 0.2)
    edge = nbr - ctr[:, None]
    z1a, z1b = nbr @ wn, edge @ we
    h1 = lr(z1a) + lr(z1b)
    z2 = h1 @ w1
    h2 = lr(z2)
    z3 = h2 @ w2
    y = lr(z3)
    acc = y.max(1, keepdims=True)
    tie = (y == acc)
    d3 = g[:, None] * tie / tie.sum(1, keepdims=True) * sl(z3)
    d2 = (d3 @ w2.T) * sl(z2)
    gh1 = d2 @ w1.T
    da, db = gh1 * sl(z1a), gh1 * sl(z1b)
    gb = db @ we.T
    gnbr = da @ wn.T + gb
    flat = lambda a: a.reshape(b * k * n, -1)
    plan = E.tiled_bwd_plan(b, k, n, IDGCN)
    part = np.zeros((plan["blocks"], E.ROWF_PART))
    for blk in range(plan["blocks"]):
        for t in range(blk, plan["row_tiles"], plan["blocks"]):
            s = slice(t * E.ROWF_TILE, (t + 1) * E.ROWF_TILE)
            for (x, d), off in zip([(nbr, da), (edge, db), (h1, d2), (h2, d3)],
                                   (WN, WE, W1, W2)):
                blockw = flat(x)[s].T @ flat(d)[s]
                part[blk, off:off + blockw.size] += blockw.ravel()
    dw = part.sum(0)
    got = (gnbr, -gb.sum(1), dw[WN:WE].reshape(32, 16), dw[WE:W1].reshape(32, 16),
           dw[W1:W2].reshape(16, 16), dw[W2:].reshape(16, 32))
    want = E.edgeconv_backward_plain(*(torch.from_numpy(a) for a in args), "max")
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, w.numpy(), rtol=3e-5, atol=3e-5,
                                   err_msg=f"gradient {i}")


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("cls", [EC0, EC0_ACTION, MSUM])
@pytest.mark.parametrize("b,k,n", [(12, 20, 1152), (12, 8, 1152), (2, 20, 77),
                                   (1, 1, 1), (3, 5, 13)])
def test_tiled_backward_plan_at_gemm_class(cls, b, k, n):
    """EdgeConv_0's and the sum's dW products on GEMM tiles in launch order
    (EdgeConv_0's dWn and dWe in its narrow tail instead), each split into
    ranges of a multiple of 8 rows covering the R rows once, in order,
    about DW_BLOCKS blocks at the train shapes; the narrow tail's blocks;
    partials and scratch (without the SharedMLP no h2 / z3 and 8 sign
    words, with it at H = 64 6 words; the edges' R C floats rounded up to
    the H / 32 words a sign move takes) the formulas' sizes."""
    mlp, c, h, o = cls
    plan = E.tiled_bwd_plan(b, k, n, cls)
    rows = b * k * n
    narrow = c % 4 != 0
    assert plan["design"] == "gemm" and plan["rows"] == rows
    assert plan["narrow"] is narrow
    assert plan["row_tiles"] * E.BWD_ROW_TILE >= rows
    assert plan["dw"] == ([(h, o), (h, h)] if mlp else []) + (
        [] if narrow else [(c, h), (c, h)])
    assert plan["products"] == (["dW2", "dW1"] if mlp else []) + (
        [] if narrow else ["dWn", "dWe"])
    part = 0
    for (m, nn), sr, splits in zip(plan["dw"], plan["split_rows"],
                                   plan["splits"]):
        assert sr % E.DW_BK == 0
        ranges = E.split_ranges(rows, sr)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        assert all(r1 == r0n for (_, r1), (r0n, _) in zip(ranges, ranges[1:]))
        tiles = -(-m // (128 if m >= 128 else 64)) * -(-nn // (128 if nn >= 128 else 64))
        assert splits * tiles <= E.DW_BLOCKS + tiles
        if rows >= E.DW_BLOCKS * E.DW_MIN_ROWS:
            assert splits * tiles >= E.DW_BLOCKS // 2
        part = max(part, splits * m * nn)
    if narrow:
        assert plan["narrow_tiles"] == -(-rows // E.NARROW_TILE)
        assert plan["blocks"] == min(E.NARROW_BLOCKS, plan["narrow_tiles"])
        part = max(part, plan["blocks"] * 2 * c * h)
    else:
        assert plan["blocks"] == 0
    assert plan["part_floats"] == part
    words = E.sign_words(mlp, h)
    assert words == (6 if mlp else 8)
    edges = -(-rows * c // (h // 32)) * (h // 32)
    assert edges == rows * c + (rows * c) % 2 * (c == 3)
    assert plan["scratch_floats"] == rows * ((2 * h + o if mlp else 2 * h)
                                             + words) + edges
    ints = E._tiled_ints(plan)
    assert ints[-1] == plan["blocks"]
    assert ints[:4] == ((plan["split_rows"] + (0, 0)) if narrow
                        else ((0, 0) if not mlp else ()) + plan["split_rows"])


@pytest.mark.parametrize("c", [6, 3])
def test_narrow_tail_threads_own_every_dw_entry_once(c):
    """bwd_narrow at EdgeConv_0 (C = 6) and the action generator's (C = 3),
    H = 64, 256 threads: thread t owns column t % H of dWn or dWe
    ((t / H) % 2) for the channels c0 .. c0 + NC below C, c0 = (t / 2 H) NC,
    NC = ceil(C / (256 / 2 H)); together every entry of both once."""
    h, threads = 64, 256
    groups = threads // (2 * h)
    nc = -(-c // groups)
    assert (groups - 1) * nc < c
    seen = np.zeros(2 * c * h, int)
    for t in range(threads):
        col, p, c0 = t % h, t // h % 2, t // (2 * h) * nc
        for i in range(nc):
            if c0 + i < c:
                seen[p * c * h + (c0 + i) * h + col] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,k,n", [(12, 20, 1152), (12, 10, 1152), (2, 20, 77),
                                   (1, 1, 1)])
def test_tiled_backward_plan_at_idgcn(b, k, n):
    """The row-fused IDGCN: 128-row tiles, at most ROWF_BLOCKS blocks (one a
    tile below that), z3 / d3 / gb scratch R O, ROWF_PART partials a block."""
    plan = E.tiled_bwd_plan(b, k, n, IDGCN)
    rows = b * k * n
    assert plan["design"] == "rows" and plan["rows"] == rows
    assert plan["row_tiles"] == -(-rows // E.ROWF_TILE)
    assert plan["blocks"] == min(E.ROWF_BLOCKS, plan["row_tiles"])
    assert plan["scratch_floats"] == rows * 32
    assert plan["part_floats"] == plan["blocks"] * E.ROWF_PART == \
        plan["blocks"] * (2 * 32 * 16 + 16 * 16 + 16 * 32)
    assert E._tiled_ints(plan) == (0, 0, 0, 0, plan["blocks"])


@pytest.mark.parametrize("cls,wide", [(EC0, 128), (EC0_ACTION, 128),
                                      (MSUM, 128), (IDGCN, 32)])
def test_tiled_backward_plan_refuses_32_bit_overflow_at_class(cls, wide):
    E.tiled_bwd_plan(1, 1, 2 ** 31 // wide - 1, cls)
    with pytest.raises(ValueError, match="plane-rows"):
        E.tiled_bwd_plan(1, 1, 2 ** 31 // wide, cls)


def test_tiled_backward_plan_refuses_other_classes():
    with pytest.raises(ValueError, match="no class"):
        E.tiled_bwd_plan(1, 4, 8, (True, 32, 16, 64))
