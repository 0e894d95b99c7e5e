"""Grouped SharedMLP + batch norm + neighbourhood max-pool, forward and
backward: the CUDA kernels ``csrc/pooled_mlp.cu`` and their plain PyTorch
versions.

Replaces ``tpugan_tpu/ops/pallas/pooled_mlp_kernel.py``:
``pooled_mlp_bn_train`` with its Pallas backward (``_bwd_pallas_bn``), and
``pooled_mlp_affine`` with its Pallas backward (``_bwd_pallas_affine``).

``FWD`` counts forward launches (one per call: the batch-norm form's layer
products, moment sums and pooling, or the affine form's pass), ``BWD``
backward launches of the batch-norm form (one per call: the tie pass, then
each layer's dW and dx products), ``AFFINE_BWD`` those of the affine form
(one per call: tie count and the apply pass). The handles load the same
library. :func:`launch_plan` gives the batch-norm form's tiles, passes and
scratch for a table shape. The kernel's source note says what bounds it on
the card and how it is laid out.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

_F = ctypes.c_float
FWD = CudaKernel("pooled_mlp", {
    "pmlp_bn_forward": [VOIDP] * 9 + [INT] * 3 + [VOIDP, INT, _F, _F, VOIDP],
    "pmlp_affine_forward": [VOIDP] * 5 + [INT] * 8 + [_F, VOIDP]})
BWD = CudaKernel("pooled_mlp", {
    "pmlp_bn_backward": [VOIDP] * 12 + [INT] * 3 + [VOIDP, INT, VOIDP, _F,
                                                    VOIDP]})
AFFINE_BWD = CudaKernel("pooled_mlp", {
    "pmlp_backward_affine": [VOIDP] * 10 + [INT] * 8 + [_F, INT, VOIDP]})

MAX_LAYERS = 4
MAX_WIDTH = 256       # widest layer output (the tie pass: a thread a column)
# The affine form's kernels: blocks of its apply pass (2 per SM), at most
# one per tile of BWD_ROWS rows.
MAX_BLOCKS = 264
BWD_ROWS = 16
# The batch-norm form's GEMM blocks (csrc/pooled_mlp.cu): 256 threads, slabs
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


def pooled_mlp_bn_forward_plain(table, ws, gammas, betas, slope, eps=1e-5):
    """(pooled, mus, vars, ivars, a_s, b_s) of the train-mode stack, pooled
    from the last layer's extremes as the kernel pools."""
    _check_slope(slope)
    x = table.float()
    mus, vars_, ivars, a_s, b_s = [], [], [], [], []
    for w, g, bt in zip(ws, gammas, betas):
        if a_s:
            x = act(z * a_s[-1] + b_s[-1], slope)
        z = torch.matmul(x, w)
        mu = z.mean(dim=(0, 1, 2))
        var = (z * z).mean(dim=(0, 1, 2)) - mu * mu
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
                                 slope):
    """(dtable, dws, dgammas, dbetas) by the kernel's formulas: the pooled
    cotangent split over the ties of the max, then the layers top down with
    the batch-norm terms S1 = sum dpre (dbeta), S2 = sum dpre zhat
    (dgamma)."""
    n = table.shape[0] * table.shape[1] * table.shape[2]
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
        dz = a_s[q] * (dpre - s1 / n - zhat * (s2 / n))
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


def launch_plan(shape: Sequence[int], widths: Sequence[int],
                slope: float) -> dict:
    """The batch-norm form's launches for a table [B, M, ns, C0] and layer
    widths: ``tile_rows`` (rows of a forward / tie-pass tile: whole
    neighbourhoods, at most ROW_TILE rows unless ns is larger),
    ``split_rows`` (rows of a dW partial, per layer), ``passes`` (kernel,
    layer, grid, dynamic shared memory in bytes, in launch order) and the
    scratch sizes in floats. Raises ValueError for what the kernels do not
    take: more than MAX_LAYERS layers, a width above MAX_WIDTH, a slope < 0
    (the pooled max is taken from the extremes of z)."""
    b, m, ns, c0 = shape
    c = [c0, *widths]
    n_layers = len(widths)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"pooled_mlp: {n_layers} layers, at most {MAX_LAYERS}")
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"pooled_mlp kernel takes layer widths <= {MAX_WIDTH}")
    _check_slope(slope)
    rows = b * m * ns
    if rows * max(c) >= 2 ** 31:
        raise ValueError(f"pooled_mlp kernel takes fewer than 2^31 elements "
                         f"per layer, got {rows} rows of up to {max(c)}")
    tile_rows = ns * max(1, min(ROW_TILE // ns, MAX_NBHD))
    tiles, row_tiles = _cdiv(rows, tile_rows), _cdiv(rows, ROW_TILE)
    passes = []
    for p in range(n_layers):
        bn = tile_width(c[p + 1])
        smem = _rows_bytes(bn, tile_rows // ns if p == n_layers - 1 else 0)
        passes.append(dict(kernel="rows_gemm", pass_="forward", layer=p,
                           grid=(tiles, _cdiv(c[p + 1], bn)), smem=smem))
    passes.append(dict(kernel="top_kernel", pass_="backward",
                       layer=n_layers - 1, grid=(tiles,), smem=0))
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
                           smem=4 * _pipe_floats(bm, bn, b_dz=True)))
        bn = tile_width(c[q])
        passes.append(dict(kernel="rows_gemm", pass_="backward", layer=q,
                           grid=(row_tiles, _cdiv(c[q], bn)),
                           smem=_rows_bytes(bn, 0, a_dz=True)))
    return dict(rows=rows, tile_rows=tile_rows, split_rows=split_rows,
                passes=passes,
                part_floats=2 * max(tiles, row_tiles) * max(widths),
                ext_floats=2 * b * m * widths[-1], dw_part_floats=dw_part)


@functools.lru_cache(maxsize=64)
def _plan(shape: Tuple[int, ...], widths: Tuple[int, ...], slope: float):
    """launch_plan, once per configuration (the train step repeats a few)."""
    return launch_plan(shape, widths, slope)


def _widths(table, ws) -> List[int]:
    c = [table.shape[-1]] + [w.shape[1] for w in ws]
    if not 1 <= len(ws) <= MAX_LAYERS:
        raise ValueError(f"pooled_mlp: {len(ws)} layers, at most {MAX_LAYERS}")
    for l, w in enumerate(ws):
        if w.shape[0] != c[l]:
            raise ValueError(f"pooled_mlp: layer {l} takes {w.shape[0]} "
                             f"channels, gets {c[l]}")
    if max(c[1:]) > MAX_WIDTH:
        raise ValueError(f"pooled_mlp kernel takes layer widths <= {MAX_WIDTH}")
    return c + [0] * (MAX_LAYERS + 1 - len(c))


def _pack(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in ts]).contiguous()


def _split(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    out, o = [], 0
    for s in shapes:
        k = 1
        for d in s:
            k *= d
        out.append(flat[o:o + k].view(s).clone())
        o += k
    return out


def _ptrs(ts: Sequence[torch.Tensor]):
    """A host array of the tensors' device pointers, for a C entry point."""
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(xs: Sequence[int]):
    return (ctypes.c_int * len(xs))(*xs)


def _check_card(table, *ts):
    if not table.is_cuda or any(t.device != table.device for t in ts):
        raise ValueError("pooled_mlp: tensors on more than one device")
    if table.dtype != torch.float32:
        raise TypeError("pooled_mlp kernel takes a float32 table")


def _launch_affine_forward(table, ws, a_s, b_s, slope):
    b, m, ns, c0 = table.shape
    c = _widths(table, ws)
    rows = b * m * ns
    pooled = torch.empty((b, m, ws[-1].shape[1]), dtype=torch.float32,
                         device=table.device)
    # packed inputs stay referenced until the launch returns
    w_flat, a_flat, b_flat = _pack(ws), _pack(a_s), _pack(b_s)
    if rows:
        FWD.launch("pmlp_affine_forward", ptr(table), ptr(w_flat), ptr(a_flat),
                   ptr(b_flat), ptr(pooled), rows, ns, len(ws), *c, _F(slope),
                   stream_of(table))
    return pooled


def _launch_bn_forward(table, ws, gammas, betas, slope, eps):
    """(pooled, zs, stats, ws): the layer outputs z_l [R, C_{l+1}] and the
    packed moments (mu, var, ivar, a, b) that the backward reads, and the
    contiguous f32 weights it launches with."""
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
    if rows:
        part = torch.empty(plan["part_floats"] + plan["ext_floats"], device=dev)
        FWD.launch("pmlp_bn_forward", ptr(table), _ptrs(ws), _ptrs(gammas),
                   _ptrs(betas), _ptrs(zs), ptr(stats), ptr(part),
                   ptr(part[plan["part_floats"]:]), ptr(pooled), rows, ns,
                   len(ws), _ints(c), plan["tile_rows"], _F(slope), _F(eps),
                   stream_of(table))
    return pooled, zs, stats, ws


def _launch_affine_backward(table, ws, a_s, b_s, pooled, g, slope):
    b, m, ns, c0 = table.shape
    c = _widths(table, ws)
    rows = b * m * ns
    dev = table.device
    hs = [w.shape[1] for w in ws]
    nblk = min(_cdiv(rows, BWD_ROWS), MAX_BLOCKS)
    w_flat = _pack(ws)
    # packed inputs stay referenced until the launch returns
    a_flat, b_flat = _pack(a_s), _pack(b_s)
    total = w_flat.numel() + 2 * sum(hs)
    dtable = torch.zeros((b, m, ns, c0), dtype=torch.float32, device=dev)
    grads = torch.zeros(total, device=dev)
    if rows:
        cnt = torch.empty_like(pooled)
        dw_part = torch.zeros((nblk, total), device=dev)
        AFFINE_BWD.launch("pmlp_backward_affine", ptr(table), ptr(w_flat),
                          ptr(a_flat), ptr(b_flat), ptr(pooled),
                          ptr(g.float().contiguous()), ptr(cnt), ptr(dw_part),
                          ptr(dtable), ptr(grads), rows, ns, len(ws), *c,
                          _F(slope), nblk, stream_of(table))
    vec = [(h,) for h in hs]
    return (dtable, _split(grads, [tuple(w.shape) for w in ws] + vec + vec))


def _launch_bn_backward(table, ws, zs, stats, pooled, g, slope):
    """(dtable, dws, dgammas, dbetas) from the forward's saved z and
    moments."""
    b, m, ns, c0 = table.shape
    hs = [w.shape[1] for w in ws]
    plan = _plan(tuple(table.shape), tuple(hs), slope)
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
        BWD.launch("pmlp_bn_backward", ptr(table), _ptrs(ws), _ptrs(zs),
                   ptr(stats), ptr(pooled), ptr(g),
                   _ptrs(dpre), ptr(part), ptr(dw_part), ptr(dtable),
                   _ptrs(dws), ptr(s12), rows, ns, len(ws),
                   _ints([c0, *hs]), plan["tile_rows"],
                   _ints(plan["split_rows"]), _F(slope), stream_of(table))
    else:
        dws = [w.zero_() for w in dws]
        s12.zero_()
    s1, s2 = s12[:sum(hs)].split(hs), s12[sum(hs):].split(hs)
    return dtable, dws, list(s2), list(s1)


# ------------------------------------------------------------ entry points

class _PooledBNTrain(torch.autograd.Function):
    """pooled_mlp_bn_train with its kernel backward. Inputs: table, slope,
    eps, L, then W_0..W_{L-1}, gamma_0.., beta_0..; outputs: pooled, then
    the L means and L variances (non-differentiable). On the card the
    forward keeps every layer's z for the backward."""

    @staticmethod
    def forward(ctx, table, slope, eps, n_layers, *params):
        ws = params[:n_layers]
        gammas = params[n_layers:2 * n_layers]
        betas = params[2 * n_layers:]
        ctx.slope, ctx.n_layers = slope, n_layers
        if table.device.type == "cpu":
            pooled, mus, vars_, ivars, a_s, b_s = pooled_mlp_bn_forward_plain(
                table, ws, gammas, betas, slope, eps)
            ctx.save_for_backward(table, pooled, *ws, *a_s, *b_s, *mus, *ivars)
        else:
            _check_card(table, *params)
            table = table.contiguous()
            pooled, zs, stats, ws = _launch_bn_forward(table, ws, gammas,
                                                       betas, slope, eps)
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
                table, ws, a_s, b_s, mus, ivars, pooled, g, ctx.slope)
        else:
            table, pooled, stats, *rest = ctx.saved_tensors
            dtable, dws, dgs, dbs = _launch_bn_backward(
                table, rest[:l], rest[l:], stats, pooled, g, ctx.slope)
        return (dtable, None, None, None, *dws, *dgs, *dbs)


def pooled_mlp_bn_train(table: torch.Tensor, ws: Sequence[torch.Tensor],
                        gammas: Sequence[torch.Tensor],
                        betas: Sequence[torch.Tensor], slope: float = 0.0,
                        eps: float = 1e-5
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
    """
    n = len(ws)
    out = _PooledBNTrain.apply(table, float(slope), float(eps), n, *ws,
                               *gammas, *betas)
    return out[0], tuple(out[1:1 + n]), tuple(out[1 + n:])


class _PooledAffine(torch.autograd.Function):
    """pooled_mlp_affine with its kernel backward. Inputs: table, slope, L,
    then W_0..W_{L-1}, a_0.., b_0..; saves them and the pooled output (the
    tie pass compares the recomputed rows with it)."""

    @staticmethod
    def forward(ctx, table, slope, n_layers, *params):
        ws, a_s = params[:n_layers], params[n_layers:2 * n_layers]
        b_s = params[2 * n_layers:]
        if table.device.type == "cpu":
            pooled = pooled_mlp_affine_plain(table, ws, a_s, b_s, slope)
        else:
            _check_card(table, *params)
            table = table.contiguous()
            pooled = _launch_affine_forward(table, ws, a_s, b_s, slope)
        ctx.slope, ctx.n_layers = slope, n_layers
        ctx.save_for_backward(table, pooled, *params)
        return pooled

    @staticmethod
    def backward(ctx, g):
        table, pooled, *params = ctx.saved_tensors
        l = ctx.n_layers
        ws, a_s, b_s = params[:l], params[l:2 * l], params[2 * l:]
        if table.device.type == "cpu":
            dtable, dws, das, dbs = pooled_mlp_affine_backward_plain(
                table, ws, a_s, b_s, pooled, g, ctx.slope)
        else:
            dtable, flat = _launch_affine_backward(table, ws, a_s, b_s, pooled,
                                                   g, ctx.slope)
            dws, das, dbs = flat[:l], flat[l:2 * l], flat[2 * l:]
        grads = [d.to(p.dtype) for d, p in zip([*dws, *das, *dbs], params)]
        return (dtable.to(table.dtype), None, None, *grads)


def pooled_mlp_affine(table: torch.Tensor, ws: Sequence[torch.Tensor],
                      a_s: Sequence[torch.Tensor], b_s: Sequence[torch.Tensor],
                      slope: float = 0.0) -> torch.Tensor:
    """act((x @ W_l) * a_l + b_l) stacked, then max over the ns axis (the
    eval-mode SetConv, and a norm-free SetConv trained fused).
    Differentiable in the table, the weights and the affines through the
    kernel backward, whose max splits the gradient over ties as ``jnp.max``
    does. A CPU table takes the plain versions; a CUDA table launches the
    kernels or raises."""
    return _PooledAffine.apply(table, float(slope), len(ws), *ws, *a_s, *b_s)
