"""Grouped SharedMLP + batch norm + neighbourhood max-pool, forward and
backward: the CUDA kernels ``csrc/pooled_mlp.cu`` and their plain PyTorch
versions.

Replaces ``tpugan_tpu/ops/pallas/pooled_mlp_kernel.py``:
``pooled_mlp_bn_train`` with its Pallas backward (``_bwd_pallas_bn``), and
``pooled_mlp_affine`` with its Pallas backward (``_bwd_pallas_affine``).

``FWD`` counts forward launches (one per call: its stats passes and the
final pass), ``BWD`` backward launches of the batch-norm form (one per call:
tie count, the S-moment passes and the apply pass), ``AFFINE_BWD`` those of
the affine form (one per call: tie count and the apply pass). The handles
load the same library.
The kernel's source note says what bounds it on the card and how it is
laid out.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

_F = ctypes.c_float
FWD = CudaKernel("pooled_mlp", {
    "pmlp_forward": [VOIDP] * 11 + [INT] * 8 + [_F, _F, INT, INT, VOIDP]})
BWD = CudaKernel("pooled_mlp", {
    "pmlp_backward": [VOIDP] * 15 + [INT] * 8 + [_F, INT, VOIDP]})
AFFINE_BWD = CudaKernel("pooled_mlp", {
    "pmlp_backward_affine": [VOIDP] * 10 + [INT] * 8 + [_F, INT, VOIDP]})

MAX_LAYERS = 4
MAX_WIDTH = 256       # widest layer output (one thread per column)
MAX_BLOCKS = 264      # blocks of the reduction passes: 2 per SM
# Rows per block for choosing the block count: no more blocks than tiles
# of this many rows. The passes stride over their tiles, and the scratch
# is sized by the block count, so any count from 1 to MAX_BLOCKS is right.
FWD_ROWS, BWD_ROWS = 32, 16


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


def pooled_mlp_bn_forward_plain(table, ws, gammas, betas, slope, eps=1e-5):
    """(pooled, mus, vars, ivars, a_s, b_s) of the train-mode stack."""
    x = table.float()
    mus, vars_, ivars, a_s, b_s = [], [], [], [], []
    for w, g, bt in zip(ws, gammas, betas):
        z = torch.matmul(x, w)
        mu = z.mean(dim=(0, 1, 2))
        var = (z * z).mean(dim=(0, 1, 2)) - mu * mu
        iv = torch.rsqrt(torch.clamp_min(var, 0.0) + eps)
        a = g * iv
        b = bt - mu * a
        mus.append(mu)
        vars_.append(var)
        ivars.append(iv)
        a_s.append(a)
        b_s.append(b)
        x = act(z * a + b, slope)
    return x.amax(dim=2), mus, vars_, ivars, a_s, b_s


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


def _check_card(table, *ts):
    if not table.is_cuda or any(t.device != table.device for t in ts):
        raise ValueError("pooled_mlp: tensors on more than one device")
    if table.dtype != torch.float32:
        raise TypeError("pooled_mlp kernel takes a float32 table")


def _nblk(rows: int, tile: int) -> int:
    return min((rows + tile - 1) // tile, MAX_BLOCKS)


def _launch_forward(table, ws, gammas, betas, a_s, b_s, slope, eps, train):
    b, m, ns, c0 = table.shape
    c = _widths(table, ws)
    rows = b * m * ns
    dev = table.device
    cout = ws[-1].shape[1]
    pooled = torch.empty((b, m, cout), dtype=torch.float32, device=dev)
    hs = [w.shape[1] for w in ws]
    tot = sum(hs)
    nblk = _nblk(rows, FWD_ROWS)
    w_flat = _pack(ws)
    if train:
        g_flat, bt_flat = _pack(gammas), _pack(betas)
        a_flat, b_flat = (torch.empty(tot, device=dev) for _ in range(2))
        mu, var, ivar = (torch.empty(tot, device=dev) for _ in range(3))
        part = torch.empty(2 * nblk * max(c[:len(ws) + 1]), device=dev)
    else:
        a_flat, b_flat = _pack(a_s), _pack(b_s)
        g_flat = bt_flat = mu = var = ivar = part = a_flat
    if rows:
        FWD.launch("pmlp_forward", ptr(table), ptr(w_flat), ptr(g_flat),
                   ptr(bt_flat), ptr(a_flat), ptr(b_flat), ptr(mu), ptr(var),
                   ptr(ivar), ptr(pooled), ptr(part), rows, ns, len(ws), *c,
                   _F(slope), _F(eps), int(train), nblk, stream_of(table))
    if not train:
        return pooled
    return (pooled, _split(mu, [(h,) for h in hs]), _split(var, [(h,) for h in hs]),
            _split(ivar, [(h,) for h in hs]), _split(a_flat, [(h,) for h in hs]),
            _split(b_flat, [(h,) for h in hs]))


def _launch_affine_backward(table, ws, a_s, b_s, pooled, g, slope):
    b, m, ns, c0 = table.shape
    c = _widths(table, ws)
    rows = b * m * ns
    dev = table.device
    hs = [w.shape[1] for w in ws]
    nblk = _nblk(rows, BWD_ROWS)
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


def _launch_backward(table, ws, a_s, b_s, mus, ivars, pooled, g, slope):
    b, m, ns, c0 = table.shape
    c = _widths(table, ws)
    rows = b * m * ns
    dev = table.device
    hs = [w.shape[1] for w in ws]
    nblk = _nblk(rows, BWD_ROWS)
    w_flat = _pack(ws)
    wtotal = w_flat.numel()
    cnt = torch.empty_like(pooled)
    s1, s2 = (torch.empty(sum(hs), device=dev) for _ in range(2))
    part = torch.empty(2 * nblk * max(c[:len(ws) + 1]), device=dev)
    dw_part = torch.zeros((nblk, wtotal), device=dev)
    dtable = torch.empty((b, m, ns, c0), dtype=torch.float32, device=dev)
    dw = torch.empty(wtotal, device=dev)
    g = g.float().contiguous()
    # packed inputs stay referenced until the launch returns
    a_flat, b_flat = _pack(a_s), _pack(b_s)
    mu_flat, ivar_flat = _pack(mus), _pack(ivars)
    if not rows:
        return (dtable, [torch.zeros_like(w) for w in ws],
                [torch.zeros(h, device=dev) for h in hs],
                [torch.zeros(h, device=dev) for h in hs])
    BWD.launch("pmlp_backward", ptr(table), ptr(w_flat), ptr(a_flat),
               ptr(b_flat), ptr(mu_flat), ptr(ivar_flat),
               ptr(pooled), ptr(g), ptr(cnt), ptr(s1), ptr(s2), ptr(part),
               ptr(dw_part), ptr(dtable), ptr(dw), rows, ns, len(ws), *c,
               _F(slope), nblk, stream_of(table))
    vec = [(h,) for h in hs]
    return (dtable, _split(dw, [tuple(w.shape) for w in ws]), _split(s2, vec),
            _split(s1, vec))


# ------------------------------------------------------------ entry points

class _PooledBNTrain(torch.autograd.Function):
    """pooled_mlp_bn_train with its kernel backward. Inputs: table, slope,
    eps, L, then W_0..W_{L-1}, gamma_0.., beta_0..; outputs: pooled, then
    the L means and L variances (non-differentiable)."""

    @staticmethod
    def forward(ctx, table, slope, eps, n_layers, *params):
        ws = params[:n_layers]
        gammas = params[n_layers:2 * n_layers]
        betas = params[2 * n_layers:]
        if table.device.type == "cpu":
            pooled, mus, vars_, ivars, a_s, b_s = pooled_mlp_bn_forward_plain(
                table, ws, gammas, betas, slope, eps)
        else:
            _check_card(table, *params)
            table = table.contiguous()
            pooled, mus, vars_, ivars, a_s, b_s = _launch_forward(
                table, ws, gammas, betas, None, None, slope, eps, True)
        ctx.slope, ctx.n_layers = slope, n_layers
        ctx.save_for_backward(table, pooled, *ws, *a_s, *b_s, *mus, *ivars)
        ctx.mark_non_differentiable(*mus, *vars_)
        return (pooled, *mus, *vars_)

    @staticmethod
    def backward(ctx, g, *_unused):
        table, pooled, *rest = ctx.saved_tensors
        l = ctx.n_layers
        ws, a_s, b_s = rest[:l], rest[l:2 * l], rest[2 * l:3 * l]
        mus, ivars = rest[3 * l:4 * l], rest[4 * l:]
        if table.device.type == "cpu":
            dtable, dws, dgs, dbs = pooled_mlp_bn_backward_plain(
                table, ws, a_s, b_s, mus, ivars, pooled, g, ctx.slope)
        else:
            dtable, dws, dgs, dbs = _launch_backward(
                table, ws, a_s, b_s, mus, ivars, pooled, g, ctx.slope)
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
    gammas / betas [C_{l+1}]. A CPU table takes the plain versions; a CUDA
    table launches the kernels or raises.
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
            pooled = _launch_forward(table, ws, None, None, a_s, b_s, slope,
                                     0.0, False)
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
