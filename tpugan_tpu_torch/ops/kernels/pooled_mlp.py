"""Grouped SharedMLP + batch norm + neighbourhood max-pool, forward and
backward: the CUDA kernels ``csrc/pooled_mlp.cu`` and their plain PyTorch
versions.

Replaces ``tpugan_tpu/ops/pallas/pooled_mlp_kernel.py``:
``pooled_mlp_bn_train`` with its Pallas backward (``_bwd_pallas_bn``), and
``pooled_mlp_affine`` with its Pallas backward (``_bwd_pallas_affine``).

``FWD`` counts forward launches of both forms (one per call: the layer
products, the batch-norm form's moment sums, and the pooling), and
``AFFINE_FWD`` those of the affine form alone; ``BWD`` backward launches of
the batch-norm form (one per call: the tie pass, then each layer's dW and
dx products), ``AFFINE_BWD`` those of the affine form (one per call: the
same passes without the batch-norm terms). A batch-norm launch whose
moments are summed over ranks (``reduce``) is several calls into the
library, one layer at a time, and counts once. The handles load the same
library. :func:`launch_plan` gives either form's tiles, passes and scratch
for a table shape. The kernel's source note says what bounds it on the
card and how it is laid out.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

_F = ctypes.c_float
FWD = CudaKernel("pooled_mlp", {
    "pmlp_bn_forward": [VOIDP] * 9 + [INT] * 3 + [VOIDP, INT, _F, _F, VOIDP],
    "pmlp_bn_forward_sums": [VOIDP] * 7 + [INT] * 3 + [VOIDP, INT, _F, INT,
                                                       VOIDP],
    "pmlp_bn_forward_finish": [VOIDP, ctypes.c_double] + [VOIDP] * 5
    + [INT] * 3 + [VOIDP, _F, _F, INT, VOIDP],
    "pmlp_affine_forward": [VOIDP] * 7 + [INT] * 3 + [VOIDP, INT, _F, VOIDP]})
_BWD_TAIL = [INT] * 3 + [VOIDP, INT, VOIDP, _F, VOIDP]
BWD = CudaKernel("pooled_mlp", {
    "pmlp_bn_backward": [VOIDP] * 12 + _BWD_TAIL,
    "pmlp_bn_backward_stage": [VOIDP] * 13 + _BWD_TAIL[:-1] + [INT, INT,
                                                               VOIDP]})
AFFINE_BWD = CudaKernel("pooled_mlp", {
    "pmlp_backward_affine": [VOIDP] * 15 + _BWD_TAIL})


class LaunchCount:
    """A count of one form's launches, which its library's handle also
    counts."""

    def __init__(self):
        self.launches = 0


AFFINE_FWD = LaunchCount()

MAX_LAYERS = 4
MAX_WIDTH = 256       # widest layer output (the tie pass: a thread a column)
# widest layer output of the affine form's forward, which has no tie pass:
# its products tile the output columns, 128 a block (the action towers'
# SA pooling is 512 wide)
MAX_AFFINE_FWD_WIDTH = 512
# The GEMM blocks of both forms (csrc/pooled_mlp.cu): 256 threads, slabs
# BK deep padded by PAD floats, STAGES slabs in flight, row tiles of
# ROW_TILE rows; a forward row tile holds at most MAX_NBHD whole
# neighbourhoods; the dW product splits the rows so that about DW_BLOCKS
# blocks run, each over at least DW_MIN_ROWS rows.
THREADS, BK, PAD, STAGES, ROW_TILE = 256, 8, 4, 3, 128
MAX_NBHD = 16
DW_BLOCKS, DW_MIN_ROWS = 264, 64
SMEM_LIMIT = 232_448  # shared memory a block may hold on the H100


def act(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Leaky ReLU written as the JAX package writes it (slope 0: ReLU)."""
    if slope == 0.0:
        return torch.clamp_min(x, 0.0)
    return torch.where(x >= 0, x, slope * x)


def _act_grad(pre: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(pre >= 0, 1.0, slope)


# ------------------------------------------------------------ plain versions

def pooled_mlp_affine_plain(table, ws, a_s, b_s, slope):
    """act((x @ W_l) * a_l + b_l) stacked, then max over the ns axis."""
    x = table.float()
    for w, a, b in zip(ws, a_s, b_s):
        x = act(torch.matmul(x, w) * a + b, slope)
    return x.amax(dim=2)


def pool_from_extremes(zmax, zmin, a, b, slope):
    """max over ns of act(z * a + b) from each neighbourhood's max and min
    of z: z * a + b and act are non-decreasing in z for a >= 0 and slope
    >= 0 (rounding is monotone) and non-increasing for a < 0, so the max is
    act(max z * a + b), or act(min z * a + b), bit for bit."""
    return act(torch.where(a >= 0, zmax, zmin) * a + b, slope)


def _check_slope(slope: float) -> None:
    if slope < 0:
        raise ValueError(f"pooled_mlp_bn_train: slope {slope} < 0; the max "
                         "is taken from the extremes of z")


def _rows(table) -> int:
    return table.shape[0] * table.shape[1] * table.shape[2]


def pooled_mlp_bn_forward_plain(table, ws, gammas, betas, slope, eps=1e-5,
                                reduce=None, world=1):
    """(pooled, mus, vars, ivars, a_s, b_s) of the train-mode stack, pooled
    from the last layer's extremes as the kernel pools. With ``reduce`` (a
    sum over ``world`` ranks of equal row counts) each layer's column sums
    and sums of squares, packed [2, C], are summed over the ranks, and the
    moments are those of every rank's rows; ``reduce`` the identity at
    world 1 gives the moments without it, bit for bit."""
    _check_slope(slope)
    x = table.float()
    n = _rows(table) * world
    mus, vars_, ivars, a_s, b_s = [], [], [], [], []
    for w, g, bt in zip(ws, gammas, betas):
        if a_s:
            x = act(z * a_s[-1] + b_s[-1], slope)
        z = torch.matmul(x, w)
        sums = torch.stack([z.sum(dim=(0, 1, 2)), (z * z).sum(dim=(0, 1, 2))])
        if reduce is not None:
            sums = reduce(sums)
        mu = sums[0] / n
        var = sums[1] / n - mu * mu
        iv = torch.rsqrt(torch.clamp_min(var, 0.0) + eps)
        a = g * iv
        mus.append(mu)
        vars_.append(var)
        ivars.append(iv)
        a_s.append(a)
        b_s.append(bt - mu * a)
    pooled = pool_from_extremes(z.amax(dim=2), z.amin(dim=2), a_s[-1],
                                b_s[-1], slope)
    return pooled, mus, vars_, ivars, a_s, b_s


def pooled_mlp_bn_backward_plain(table, ws, a_s, b_s, mus, ivars, pooled, g,
                                 slope, reduce=None, world=1):
    """(dtable, dws, dgammas, dbetas) by the kernel's formulas: the pooled
    cotangent split over the ties of the max, then the layers top down with
    the batch-norm terms S1 = sum dpre (dbeta), S2 = sum dpre zhat
    (dgamma). With ``reduce`` (the forward's) each layer's S1 and S2,
    packed [2, C], are summed over the ranks before its dz reads them, over
    ``world`` times the rows; dW, dgamma and dbeta stay sums over this
    rank's rows (what autograd gives a rank through the plain stack under
    ``cross_rank_stats``)."""
    n = _rows(table) * world
    xs, zs = [table.float()], []
    for w, a, b in zip(ws, a_s, b_s):
        zs.append(torch.matmul(xs[-1], w))
        xs.append(act(zs[-1] * a + b, slope))
    tie = (xs[-1] == pooled[:, :, None, :]).float()
    dx = tie * (g / tie.sum(dim=2))[:, :, None, :]
    dws, dgammas, dbetas = [None] * len(ws), [None] * len(ws), [None] * len(ws)
    for q in range(len(ws) - 1, -1, -1):
        pre = zs[q] * a_s[q] + b_s[q]
        dpre = dx * _act_grad(pre, slope)
        zhat = (zs[q] - mus[q]) * ivars[q]
        s1 = dpre.sum(dim=(0, 1, 2))
        s2 = (dpre * zhat).sum(dim=(0, 1, 2))
        g1, g2 = (s1, s2) if reduce is None else reduce(torch.stack([s1, s2]))
        dz = a_s[q] * (dpre - g1 / n - zhat * (g2 / n))
        dws[q] = torch.einsum("bmnc,bmnh->ch", xs[q], dz)
        dgammas[q], dbetas[q] = s2, s1
        dx = torch.matmul(dz, ws[q].t())
    return dx, dws, dgammas, dbetas


def pooled_mlp_affine_backward_plain(table, ws, a_s, b_s, pooled, g, slope):
    """(dtable, dws, das, dbs) of :func:`pooled_mlp_affine_plain` by the
    kernel's formulas: the pooled cotangent split over the ties of the max,
    then top down dpre = dx act'(pre), dz = a dpre, da = sum dpre z,
    db = sum dpre, dW = x^T dz, dx = dz W^T."""
    xs, zs = [table.float()], []
    for w, a, b in zip(ws, a_s, b_s):
        zs.append(torch.matmul(xs[-1], w))
        xs.append(act(zs[-1] * a + b, slope))
    tie = (xs[-1] == pooled[:, :, None, :]).float()
    dx = tie * (g / tie.sum(dim=2))[:, :, None, :]
    n = len(ws)
    dws, das, dbs = [None] * n, [None] * n, [None] * n
    for q in range(n - 1, -1, -1):
        dpre = dx * _act_grad(zs[q] * a_s[q] + b_s[q], slope)
        das[q] = (dpre * zs[q]).sum(dim=(0, 1, 2))
        dbs[q] = dpre.sum(dim=(0, 1, 2))
        dz = dpre * a_s[q]
        dws[q] = torch.einsum("bmnc,bmnh->ch", xs[q], dz)
        dx = torch.matmul(dz, ws[q].t())
    return dx, dws, das, dbs


# ------------------------------------------------------------ kernel launches

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_width(n: int) -> int:
    """Columns of a product tile for output width n: 64 or 128, whichever
    pads n less (128 on a tie); ``tile_width`` in csrc/pooled_mlp.cu."""
    return 64 if n <= 64 or _cdiv(n, 64) * 64 < _cdiv(n, 128) * 128 else 128


def _pipe_floats(bm: int, bn: int, a_dz: bool = False,
                 b_dz: bool = False) -> int:
    """Shared memory of the GEMM block's pipeline (``pipe_floats``): STAGES
    slabs of A [BK][bm + PAD] and B [BK][bn + PAD], each twice for an
    operand formed from dpre and z (dz)."""
    return STAGES * BK * ((1 + a_dz) * (bm + PAD) + (1 + b_dz) * (bn + PAD))


def _rows_bytes(bn: int, nbh: int, a_dz: bool = False) -> int:
    """Shared memory of a row-major product's block (``rows_gemm``): the
    pipeline or the product tile [ROW_TILE][bn + PAD] over it, the column
    sums (2 x 2,048 / bn row groups x bn), the running extremes of nbh
    neighbourhoods."""
    head = max(_pipe_floats(ROW_TILE, bn, a_dz=a_dz), ROW_TILE * (bn + PAD))
    return 4 * (head + 2 * (THREADS // (bn // 4)) * bn + 2 * nbh * bn)


def _check_widths(widths: Sequence[int], cap: int) -> None:
    if not 1 <= len(widths) <= MAX_LAYERS:
        raise ValueError(f"pooled_mlp: {len(widths)} layers, at most {MAX_LAYERS}")
    if max(widths) > cap:
        raise ValueError(f"pooled_mlp kernel takes layer widths <= {cap}")


def forward_plan(shape: Sequence[int], widths: Sequence[int], slope: float,
                 affine: bool = False) -> dict:
    """The forward's launches for a table [B, M, ns, C0] and layer widths:
    ``tile_rows`` (rows of a forward tile: whole neighbourhoods, at most
    ROW_TILE rows unless ns is larger), ``passes`` (kernel, layer, grid,
    dynamic shared memory in bytes, in launch order) and the scratch sizes
    in floats. Raises ValueError for what the kernels do not take: more
    than MAX_LAYERS layers, a width above MAX_WIDTH (MAX_AFFINE_FWD_WIDTH
    for the ``affine`` form, whose forward sums no moments), a slope < 0
    (the pooled max is taken from the extremes of z)."""
    b, m, ns, c0 = shape
    c = [c0, *widths]
    _check_widths(widths, MAX_AFFINE_FWD_WIDTH if affine else MAX_WIDTH)
    _check_slope(slope)
    rows = b * m * ns
    if rows * max(c) >= 2 ** 31:
        raise ValueError(f"pooled_mlp kernel takes fewer than 2^31 elements "
                         f"per layer, got {rows} rows of up to {max(c)}")
    tile_rows = ns * max(1, min(ROW_TILE // ns, MAX_NBHD))
    tiles = _cdiv(rows, tile_rows)
    passes = []
    for p in range(len(widths)):
        bn = tile_width(c[p + 1])
        smem = _rows_bytes(bn, tile_rows // ns if p == len(widths) - 1 else 0)
        passes.append(dict(kernel="rows_gemm", pass_="forward", layer=p,
                           grid=(tiles, _cdiv(c[p + 1], bn)), smem=smem))
    return dict(rows=rows, tile_rows=tile_rows, tiles=tiles, passes=passes,
                ext_floats=2 * b * m * widths[-1])


def launch_plan(shape: Sequence[int], widths: Sequence[int],
                slope: float, affine: bool = False) -> dict:
    """The forward and backward launches of the batch-norm form (``affine``:
    of the affine form, whose dz operand reads no z and whose forward sums
    no moments) for a table [B, M, ns, C0] and layer widths:
    :func:`forward_plan`'s, then ``split_rows`` (rows of a dW partial, per
    layer) and the backward's passes and scratch. Both forms' backwards
    take widths up to MAX_WIDTH (the tie pass)."""
    _check_widths(widths, MAX_WIDTH)
    plan = forward_plan(shape, widths, slope, affine)
    c = [shape[-1], *widths]
    rows, n_layers = plan["rows"], len(widths)
    row_tiles = _cdiv(rows, ROW_TILE)
    passes = plan["passes"]
    passes.append(dict(kernel="top_kernel", pass_="backward",
                       layer=n_layers - 1, grid=(plan["tiles"],), smem=0))
    split_rows, dw_part = [0] * n_layers, 0
    for q in reversed(range(n_layers)):
        bm, bn = tile_width(c[q]), tile_width(c[q + 1])
        out_tiles = _cdiv(c[q], bm) * _cdiv(c[q + 1], bn)
        splits = max(1, min(_cdiv(rows, DW_MIN_ROWS),
                            _cdiv(DW_BLOCKS, out_tiles)))
        split_rows[q] = max(BK, _cdiv(_cdiv(rows, splits), BK) * BK)
        splits = max(1, _cdiv(rows, split_rows[q]))
        dw_part = max(dw_part, splits * c[q] * c[q + 1])
        passes.append(dict(kernel="dw_gemm", pass_="backward", layer=q,
                           grid=(_cdiv(c[q], bm), _cdiv(c[q + 1], bn), splits),
                           smem=4 * _pipe_floats(bm, bn, b_dz=not affine)))
        bn = tile_width(c[q])
        passes.append(dict(kernel="rows_gemm", pass_="backward", layer=q,
                           grid=(row_tiles, _cdiv(c[q], bn)),
                           smem=_rows_bytes(bn, 0, a_dz=not affine)))
    return dict(plan, split_rows=split_rows, passes=passes,
                part_floats=2 * max(plan["tiles"], row_tiles) * max(widths),
                dw_part_floats=dw_part)


@functools.lru_cache(maxsize=64)
def _plan(shape: Tuple[int, ...], widths: Tuple[int, ...], slope: float,
          affine: bool = False, forward_only: bool = False):
    """launch_plan (forward_plan with ``forward_only``), once per
    configuration (the train step repeats a few)."""
    if forward_only:
        return forward_plan(shape, widths, slope, affine)
    return launch_plan(shape, widths, slope, affine)


def _widths(table, ws) -> List[int]:
    c = [table.shape[-1]] + [w.shape[1] for w in ws]
    _check_widths(c[1:], MAX_AFFINE_FWD_WIDTH)
    for l, w in enumerate(ws):
        if w.shape[0] != c[l]:
            raise ValueError(f"pooled_mlp: layer {l} takes {w.shape[0]} "
                             f"channels, gets {c[l]}")
    return c + [0] * (MAX_LAYERS + 1 - len(c))


def _ptrs(ts: Sequence[torch.Tensor]):
    """A host array of the tensors' device pointers (None: a null pointer),
    for a C entry point."""
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def _ints(xs: Sequence[int]):
    return (ctypes.c_int * len(xs))(*xs)


def _check_card(table, *ts):
    if not table.is_cuda or any(t.device != table.device for t in ts):
        raise ValueError("pooled_mlp: tensors on more than one device")
    if table.dtype != torch.float32:
        raise TypeError("pooled_mlp kernel takes a float32 table")


@functools.lru_cache(maxsize=8)
def _units(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """MAX_WIDTH zeros and ones on ``device``: the affine backward's mu and
    ivar (made once a device)."""
    return (torch.zeros(MAX_WIDTH, device=device),
            torch.ones(MAX_WIDTH, device=device))


def _launch_affine_forward(table, ws, a_s, b_s, slope, keep):
    """(pooled, zs, ws, a_s, b_s): with ``keep``, every layer's z [R,
    C_{l+1}] for the backward, with the contiguous f32 weights and affines
    it launches with (widths up to MAX_WIDTH, the backward's); otherwise zs
    is empty and the layers below the top write their z into two
    alternating buffers, the top none (widths up to
    MAX_AFFINE_FWD_WIDTH)."""
    b, m, ns, c0 = table.shape
    _widths(table, ws)
    hs = [w.shape[1] for w in ws]
    # the backward (which reads the kept z) takes widths up to MAX_WIDTH
    plan = _plan(tuple(table.shape), tuple(hs), slope, True, not keep)
    rows, dev = plan["rows"], table.device
    ws, a_s, b_s = ([x.float().contiguous() for x in xs]
                    for xs in (ws, a_s, b_s))
    pooled = torch.empty((b, m, hs[-1]), dtype=torch.float32, device=dev)
    if keep:
        zs = [torch.empty((rows, h), device=dev) for h in hs]
        out = zs
    else:
        zs = []
        bufs = [torch.empty(rows * max(hs[:-1]), device=dev)
                for _ in range(min(2, len(hs) - 1))]
        out = [bufs[p % 2][:rows * h].view(rows, h)
               for p, h in enumerate(hs[:-1])] + [None]
    if rows:
        ext = torch.empty(plan["ext_floats"], device=dev)
        FWD.launch("pmlp_affine_forward", ptr(table), _ptrs(ws), _ptrs(a_s),
                   _ptrs(b_s), _ptrs(out), ptr(ext), ptr(pooled), rows, ns,
                   len(ws), _ints([c0, *hs]), plan["tile_rows"], _F(slope),
                   stream_of(table))
        AFFINE_FWD.launches += 1
    return pooled, zs, ws, a_s, b_s


def _launch_bn_forward(table, ws, gammas, betas, slope, eps, reduce=None,
                       world=1):
    """(pooled, zs, stats, ws): the layer outputs z_l [R, C_{l+1}] and the
    packed moments (mu, var, ivar, a, b) that the backward reads, and the
    contiguous f32 weights it launches with. With ``reduce``, one layer at
    a time: its column sums [2, C_{l+1}] (f64) summed over the ranks before
    its moments are formed over ``world`` times the rows."""
    b, m, ns, c0 = table.shape
    c = _widths(table, ws)
    hs = [w.shape[1] for w in ws]
    plan = _plan(tuple(table.shape), tuple(hs), slope)
    rows, dev = plan["rows"], table.device
    ws = [w.float().contiguous() for w in ws]
    gammas = [x.float().contiguous() for x in gammas]
    betas = [x.float().contiguous() for x in betas]
    zs = [torch.empty((rows, h), device=dev) for h in hs]
    stats = torch.empty(5 * sum(hs), device=dev)
    pooled = torch.empty((b, m, hs[-1]), dtype=torch.float32, device=dev)
    if reduce is not None and not rows:
        raise ValueError("pooled_mlp: an empty table takes no cross-rank "
                         "moments")
    if rows:
        part = torch.empty(plan["part_floats"] + plan["ext_floats"], device=dev)
        ext = part[plan["part_floats"]:]
        if reduce is None:
            FWD.launch("pmlp_bn_forward", ptr(table), _ptrs(ws), _ptrs(gammas),
                       _ptrs(betas), _ptrs(zs), ptr(stats), ptr(part),
                       ptr(ext), ptr(pooled), rows, ns, len(ws), _ints(c),
                       plan["tile_rows"], _F(slope), _F(eps),
                       stream_of(table))
            return pooled, zs, stats, ws
        for p, h in enumerate(hs):
            sums = torch.empty((2, h), dtype=torch.float64, device=dev)
            FWD.launch("pmlp_bn_forward_sums", ptr(table), _ptrs(ws),
                       _ptrs(zs), ptr(stats), ptr(part), ptr(ext), ptr(sums),
                       rows, ns, len(ws), _ints(c), plan["tile_rows"],
                       _F(slope), p, stream_of(table), count=False)
            sums = reduce(sums).contiguous()
            FWD.launch("pmlp_bn_forward_finish", ptr(sums),
                       ctypes.c_double(rows * world), ptr(gammas[p]),
                       ptr(betas[p]), ptr(stats), ptr(ext), ptr(pooled), rows,
                       ns, len(ws), _ints(c), _F(slope), _F(eps), p,
                       stream_of(table), count=False)
        FWD.launches += 1
    return pooled, zs, stats, ws


def _launch_bn_backward(table, ws, zs, stats, pooled, g, slope,
                        affine=None, reduce=None, world=1):
    """(dtable, dws, dgammas, dbetas) from the forward's saved z and
    moments; ``affine`` (a_s, b_s): (dtable, dws, das, dbs) of the affine
    form from its saved z and its affines (``stats`` unused). With
    ``reduce`` (the batch-norm form's forward's), in stages: each layer's
    S1, S2 [2, C_{l+1}] summed over the ranks before its dz reads them."""
    b, m, ns, c0 = table.shape
    hs = [w.shape[1] for w in ws]
    plan = _plan(tuple(table.shape), tuple(hs), slope, affine is not None)
    rows, dev = plan["rows"], table.device
    dtable = torch.empty((b, m, ns, c0), dtype=torch.float32, device=dev)
    dws = [torch.empty(w.shape, device=dev) for w in ws]
    s12 = torch.empty(2 * sum(hs), device=dev)
    if rows:
        # scratch: dpre of every layer, the S1 / S2 partials, the dW partials
        sizes = [rows * h for h in hs] + [plan["part_floats"],
                                          plan["dw_part_floats"]]
        *dpre, part, dw_part = torch.empty(sum(sizes), device=dev).split(sizes)
        g = g.float().contiguous()
        if affine is None:
            handle, symbol, vecs = BWD, "pmlp_bn_backward", (ptr(stats),)
        else:
            handle, symbol = AFFINE_BWD, "pmlp_backward_affine"
            zeros, ones = _units(dev)
            vecs = (_ptrs(affine[0]), _ptrs(affine[1]), ptr(zeros), ptr(ones))
        if reduce is None:
            handle.launch(symbol, ptr(table), _ptrs(ws), _ptrs(zs), *vecs,
                          ptr(pooled), ptr(g), _ptrs(dpre), ptr(part),
                          ptr(dw_part), ptr(dtable), _ptrs(dws), ptr(s12),
                          rows, ns, len(ws), _ints([c0, *hs]),
                          plan["tile_rows"], _ints(plan["split_rows"]),
                          _F(slope), stream_of(table))
        else:
            _staged_bn_backward(table, ws, zs, stats, pooled, g, dpre, part,
                                dw_part, dtable, dws, s12, plan, slope,
                                reduce, world)
    else:
        dws = [w.zero_() for w in dws]
        s12.zero_()
    s1, s2 = s12[:sum(hs)].split(hs), s12[sum(hs):].split(hs)
    return dtable, dws, list(s2), list(s1)


def _staged_bn_backward(table, ws, zs, stats, pooled, g, dpre, part,
                        dw_part, dtable, dws, s12, plan, slope, reduce,
                        world):
    """pmlp_bn_backward in stages (``pmlp_bn_backward_stage``): the top
    pass, then each layer's products top down; after each pass that wrote
    a layer's S1, S2 into ``s12`` they are summed over the ranks into the
    copy that the next pass's dz reads. Counted once."""
    b, m, ns, c0 = table.shape
    hs = [w.shape[1] for w in ws]
    tot, offs = sum(hs), [sum(hs[:l]) for l in range(len(hs))]
    s12g = torch.empty_like(s12)
    c = _ints([c0, *hs])

    def stage(st):
        BWD.launch("pmlp_bn_backward_stage", ptr(table), _ptrs(ws),
                   _ptrs(zs), ptr(stats), ptr(pooled), ptr(g), _ptrs(dpre),
                   ptr(part), ptr(dw_part), ptr(dtable), _ptrs(dws), ptr(s12),
                   ptr(s12g), plan["rows"], ns, len(ws), c, plan["tile_rows"],
                   _ints(plan["split_rows"]), _F(slope), plan["rows"] * world,
                   st, stream_of(table), count=False)

    def summed(q):
        h, n = offs[q], hs[q]
        both = reduce(torch.stack([s12[h:h + n], s12[tot + h:tot + h + n]]))
        s12g[h:h + n] = both[0]
        s12g[tot + h:tot + h + n] = both[1]

    stage(len(ws))
    summed(len(ws) - 1)
    for q in reversed(range(len(ws))):
        stage(q)
        if q:
            summed(q - 1)
    BWD.launches += 1


def _plain_sum(reduce):
    """``reduce`` outside autograd: the kernels' sums carry no graph."""
    if reduce is None:
        return None

    def summed(t):
        with torch.no_grad():
            return reduce(t)

    return summed


# ------------------------------------------------------------ entry points

class _PooledBNTrain(torch.autograd.Function):
    """pooled_mlp_bn_train with its kernel backward. Inputs: table, slope,
    eps, L, reduce, world, then W_0..W_{L-1}, gamma_0.., beta_0..; outputs:
    pooled, then the L means and L variances (non-differentiable). On the
    card the forward keeps every layer's z for the backward."""

    @staticmethod
    def forward(ctx, table, slope, eps, n_layers, reduce, world, *params):
        ws = params[:n_layers]
        gammas = params[n_layers:2 * n_layers]
        betas = params[2 * n_layers:]
        ctx.slope, ctx.n_layers = slope, n_layers
        ctx.reduce, ctx.world = reduce, world
        if table.device.type == "cpu":
            pooled, mus, vars_, ivars, a_s, b_s = pooled_mlp_bn_forward_plain(
                table, ws, gammas, betas, slope, eps, reduce, world)
            ctx.save_for_backward(table, pooled, *ws, *a_s, *b_s, *mus, *ivars)
        else:
            _check_card(table, *params)
            table = table.contiguous()
            pooled, zs, stats, ws = _launch_bn_forward(
                table, ws, gammas, betas, slope, eps, reduce, world)
            hs = [w.shape[1] for w in ws]
            mus = stats[:sum(hs)].split(hs)
            vars_ = stats[sum(hs):2 * sum(hs)].split(hs)
            ctx.save_for_backward(table, pooled, stats, *ws, *zs)
        ctx.mark_non_differentiable(*mus, *vars_)
        return (pooled, *mus, *vars_)

    @staticmethod
    def backward(ctx, g, *_unused):
        l = ctx.n_layers
        if ctx.saved_tensors[0].device.type == "cpu":
            table, pooled, *rest = ctx.saved_tensors
            ws, a_s, b_s = rest[:l], rest[l:2 * l], rest[2 * l:3 * l]
            mus, ivars = rest[3 * l:4 * l], rest[4 * l:]
            dtable, dws, dgs, dbs = pooled_mlp_bn_backward_plain(
                table, ws, a_s, b_s, mus, ivars, pooled, g, ctx.slope,
                ctx.reduce, ctx.world)
        else:
            table, pooled, stats, *rest = ctx.saved_tensors
            dtable, dws, dgs, dbs = _launch_bn_backward(
                table, rest[:l], rest[l:], stats, pooled, g, ctx.slope,
                reduce=ctx.reduce, world=ctx.world)
        return (dtable, None, None, None, None, None, *dws, *dgs, *dbs)


def pooled_mlp_bn_train(table: torch.Tensor, ws: Sequence[torch.Tensor],
                        gammas: Sequence[torch.Tensor],
                        betas: Sequence[torch.Tensor], slope: float = 0.0,
                        eps: float = 1e-5,
                        reduce: Optional[Callable[[torch.Tensor],
                                                  torch.Tensor]] = None,
                        world: int = 1
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                                   Tuple[torch.Tensor, ...]]:
    """Train-mode batch-norm stack + max-pool: (pooled [B, M, C_out],
    means, biased variances) with the batch moments over all B*M*ns rows.
    Differentiable in the table, weights, gammas and betas through the
    kernel backward; the moments are running-stat values and carry no
    gradient.

    table [B, M, ns, C] f32, ws[l] [C_l, C_{l+1}] (the effective kernels),
    gammas / betas [C_{l+1}], slope >= 0 (the max is taken from the
    extremes of the last layer's pre-norm output). A CPU table takes the
    plain versions; a CUDA table launches the kernels or raises.

    ``reduce`` (a sum of a tensor over ``world`` ranks of equal row counts,
    called outside autograd; the data-parallel step's cross-rank moments):
    each layer's column sums and sums of squares are summed over the ranks
    before its moments are formed, in the forward, and its S1, S2 before
    its dz, in the backward: one call of ``reduce`` a layer each way. The
    moments are then every rank's rows', and the gradients this rank's
    share of the global batch's (dW, dgamma, dbeta sums over its rows),
    as autograd gives them through the plain stack. Without it the kernel
    runs as one call, and with the identity at world 1 its stages give
    the same result bit for bit.
    """
    n = len(ws)
    out = _PooledBNTrain.apply(table, float(slope), float(eps), n,
                               _plain_sum(reduce), int(world), *ws, *gammas,
                               *betas)
    return out[0], tuple(out[1:1 + n]), tuple(out[1 + n:])


class _PooledAffine(torch.autograd.Function):
    """pooled_mlp_affine with its kernel backward. Inputs: table, slope, L,
    then W_0..W_{L-1}, a_0.., b_0..; on the CPU saves them and the pooled
    output (the plain backward recomputes the stack), on the card the
    forward's every z, when a gradient is wanted."""

    @staticmethod
    def forward(ctx, table, slope, n_layers, *params):
        ws, a_s = params[:n_layers], params[n_layers:2 * n_layers]
        b_s = params[2 * n_layers:]
        ctx.slope, ctx.n_layers = slope, n_layers
        ctx.dtypes = [table.dtype] + [p.dtype for p in params]
        ctx.on_card = table.device.type != "cpu"
        if not ctx.on_card:
            pooled = pooled_mlp_affine_plain(table, ws, a_s, b_s, slope)
            ctx.save_for_backward(table, pooled, *params)
            return pooled
        _check_card(table, *params)
        keep = any(ctx.needs_input_grad)
        pooled, zs, ws, a_s, b_s = _launch_affine_forward(
            table.contiguous(), ws, a_s, b_s, slope, keep)
        if keep:
            ctx.save_for_backward(table.contiguous(), pooled, *ws, *zs, *a_s,
                                  *b_s)
        return pooled

    @staticmethod
    def backward(ctx, g):
        l = ctx.n_layers
        if ctx.on_card:
            table, pooled, *rest = ctx.saved_tensors
            dtable, dws, das, dbs = _launch_bn_backward(
                table, rest[:l], rest[l:2 * l], None, pooled, g, ctx.slope,
                affine=(rest[2 * l:3 * l], rest[3 * l:]))
        else:
            table, pooled, *params = ctx.saved_tensors
            ws, a_s, b_s = params[:l], params[l:2 * l], params[2 * l:]
            dtable, dws, das, dbs = pooled_mlp_affine_backward_plain(
                table, ws, a_s, b_s, pooled, g, ctx.slope)
        grads = [d.to(t) for d, t in zip([dtable, *dws, *das, *dbs],
                                         ctx.dtypes)]
        return (grads[0], None, None, *grads[1:])


def pooled_mlp_affine(table: torch.Tensor, ws: Sequence[torch.Tensor],
                      a_s: Sequence[torch.Tensor], b_s: Sequence[torch.Tensor],
                      slope: float = 0.0) -> torch.Tensor:
    """act((x @ W_l) * a_l + b_l) stacked, then max over the ns axis (the
    eval-mode SetConv, and a norm-free SetConv trained fused).
    Differentiable in the table, the weights and the affines through the
    kernel backward, whose max splits the gradient over ties as ``jnp.max``
    does. A CPU table takes the plain versions; a CUDA table launches the
    kernels or raises, and takes slope >= 0 (the max is taken from the
    extremes of the last layer's z, as in :func:`pooled_mlp_bn_train`) and
    layer widths up to MAX_AFFINE_FWD_WIDTH where no gradient can be asked
    for, up to MAX_WIDTH (the backward's) where one can."""
    params = [*ws, *a_s, *b_s]
    if table.device.type != "cpu" and not (
            torch.is_grad_enabled()
            and any(t.requires_grad for t in [table, *params])):
        # no gradient can be asked for: the launch alone, no z kept
        _check_card(table, *params)
        return _launch_affine_forward(table.contiguous(), ws, a_s, b_s,
                                      float(slope), False)[0]
    return _PooledAffine.apply(table, float(slope), len(ws), *params)
