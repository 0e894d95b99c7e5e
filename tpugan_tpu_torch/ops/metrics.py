"""Distance metrics on padded point batches (``tpugan_tpu/ops/metrics.py``):
nearest neighbour, Chamfer distance, the masking-loss target, the auction
assignment with its EMD, and the Gaussian MMD.

The nearest-neighbour distance is differentiable (:class:`_Nn1`), with the
gather and scatter-add formula the JAX kNN kernel's VJP uses for k = 1. The
auction and the MMD are plain PyTorch (the JAX package has no Pallas kernel
for them either): every round regenerates cost rows from the points in
query-row blocks, so no [N, N] matrix sits whole in memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpugan_tpu_torch.ops.kernels.nn1 import nn1_kernel
from tpugan_tpu_torch.ops.neighbors import (_CHUNK, pairwise_sqdist,
                                            radius_count, scatter_sqdist_grad,
                                            valid_bias)


class _Nn1(torch.autograd.Function):
    """The nn1 kernel with a differentiable distance output."""

    @staticmethod
    def forward(ctx, query, cand, bias):
        d2, idx = nn1_kernel(query, cand, bias)
        ctx.save_for_backward(query, cand, idx)
        ctx.mark_non_differentiable(idx)
        return d2, idx

    @staticmethod
    def backward(ctx, g_d2, _):
        query, cand, idx = ctx.saved_tensors
        gq, gc = scatter_sqdist_grad(query, cand, idx[..., None],
                                     g_d2[..., None])
        return gq, gc, None


def nearest_neighbor(query: torch.Tensor, cand: torch.Tensor,
                     c_valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbour of each query point: (d2 [B, Nq] f32,
    idx [B, Nq] int64). On the card this is the nn1 kernel at every size
    (it streams candidates, so it has no candidate cap)."""
    query, cand = query.float(), cand.float()
    return _Nn1.apply(query, cand,
                      valid_bias(c_valid, cand.shape[:-1], cand.device))


def chamfer(a: torch.Tensor, b: torch.Tensor,
            a_valid: Optional[torch.Tensor] = None,
            b_valid: Optional[torch.Tensor] = None,
            bidirectional: bool = True) -> torch.Tensor:
    """Masked Chamfer distance, per cloud: the sum of squared
    nearest-neighbour distances a -> b, plus b -> a when bidirectional.
    Invalid points count 0 as queries and are never selected as
    neighbours. Returns [B]."""
    d2_ab, _ = nearest_neighbor(a, b, c_valid=b_valid)
    if a_valid is not None:
        d2_ab = torch.where(a_valid, d2_ab, 0.0)
    out = d2_ab.sum(-1)
    if bidirectional:
        d2_ba, _ = nearest_neighbor(b, a, c_valid=a_valid)
        if b_valid is not None:
            d2_ba = torch.where(b_valid, d2_ba, 0.0)
        out = out + d2_ba.sum(-1)
    return out


def masking_target(pos_gt: torch.Tensor, pos_input: torch.Tensor,
                   particle_radius: float,
                   gt_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Target of the keep-probability head, [B, N_input] in {0, 1}: a
    ground-truth point is dense with more than 3 neighbours within
    1.4 * radius (capped at 16); an input point takes the density bit of
    its nearest ground-truth point within 1.9 * radius, else 0."""
    cnt = radius_count(pos_gt, pos_gt, 1.4 * particle_radius, cap=16,
                       c_valid=gt_valid)
    dense = (cnt > 3).float()
    with torch.no_grad():
        d2, idx = nearest_neighbor(pos_input, pos_gt, c_valid=gt_valid)
    in_range = d2 < (1.9 * particle_radius) ** 2
    return torch.where(in_range, torch.gather(dense, 1, idx), 0.0)


# Per-phase eps decay of the auction's eps-scaling schedule (the JAX
# package's measured choice: 6x steps keep each phase's reassignment short).
_THETA = 6.0
_NEG = -1e30
# Rounds bid by every auction since this was last set to 0 (a diagnostic,
# as the kernels' launch counts are).
auction_rounds = 0


def _auction_phase(x: torch.Tensor, y: torch.Tensor, price: torch.Tensor,
                   eps: float, iters: int,
                   assign0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One eps-phase of the Jacobi auction: at most ``iters`` rounds, from
    ``assign0`` (all unassigned when None) and ``price``. Returns (price,
    assign) with assign[i] the object of bidder i or -1.

    A round: every unassigned bidder bids for its best object (value
    -|x_i - y_j|^2 - price_j) by the gap to its second best plus eps; each
    object with bids goes to its highest bid, ties to the lowest bidder
    index, and its price rises by that bid; the object's previous holder
    becomes unassigned. The lowest-index winner is ``scatter_reduce``'s
    ``amin`` over the bidders whose bid equals the object's ``amax``.

    The host reads the unassigned bidders every round (the JAX while_loop's
    check before each round) and regenerates cost rows for those bidders
    only, in blocks of rows: an assigned bidder's bid is masked out in the
    JAX form, so leaving its row out changes nothing. A round in the
    auction's tail of a few contested bidders is still a host read and a
    chain of small launches, and the tail can run the whole round budget:
    one auction at n = 9,216 and 2,000 rounds a phase took 24 s on an
    "NVIDIA H100 80GB HBM3, 700.00 W".
    """
    global auction_rounds
    b, n, _ = x.shape
    # bound the transient [rows, N] value blocks to about 1 GB
    rows_max = max(256, min(_CHUNK, (((1 << 30) // (n * 4)) // 128) * 128))
    iota = torch.arange(n, device=x.device).expand(b, n)
    assign = (torch.full((b, n), -1, dtype=torch.int64, device=x.device)
              if assign0 is None else assign0.clone())
    for _ in range(iters):
        unassigned = assign < 0
        todo = [unassigned[bi].nonzero()[:, 0] for bi in range(b)]
        if not any(t.numel() for t in todo):
            break
        auction_rounds += 1
        best_j = torch.zeros((b, n), dtype=torch.int64, device=x.device)
        bid = torch.full((b, n), _NEG, device=x.device)
        for bi, rows in enumerate(todo):
            for s in range(0, rows.numel(), rows_max):
                r = rows[s:s + rows_max]
                v = -pairwise_sqdist(x[bi, r], y[bi]) - price[bi]
                v1, a1 = v.max(-1)
                v2 = v.scatter(-1, a1[:, None], _NEG).amax(-1)
                best_j[bi, r] = a1
                bid[bi, r] = (v1 - v2) + eps
        bid_max = torch.full((b, n), _NEG, device=x.device).scatter_reduce(
            1, best_j, bid, "amax")
        top = bid >= torch.gather(bid_max, 1, best_j)
        winner = torch.full((b, n), n, dtype=torch.int64,
                            device=x.device).scatter_reduce(
            1, best_j, torch.where(top, iota, n), "amin")
        got = bid_max > _NEG
        price = price + torch.where(got, bid_max, 0.0)
        won = unassigned & (torch.gather(winner, 1, best_j) == iota)
        # a holder is evicted iff its object was re-auctioned (this round's
        # winners were unassigned bidders, a disjoint set)
        lost = (assign >= 0) & torch.gather(got, 1, assign.clamp_min(0))
        assign = torch.where(won, best_j, torch.where(lost, -1, assign))
    return price, assign


# clouds this large are auctioned one batch item at a time with eps scaling
# (the JAX package's threshold)
SPLIT_ITEMS_AT = 32768


def auction_assignment(x: torch.Tensor, y: torch.Tensor, eps: float = 0.05,
                       iters: int = 100, phases: int = 1,
                       theta: Optional[float] = None,
                       final_iters: Optional[int] = None) -> torch.Tensor:
    """Approximate min-cost bijection x[i] -> y[assignment[i]] (cost the
    squared distance) by the Bertsekas auction, as a Jacobi auction.

    ``phases > 1`` turns on eps scaling anchored at the data's scale: the
    first phase runs at eps0 = max(|bounding-box diagonal|^2 / 4, eps) of
    the joint cloud, later phases step down by about ``_THETA`` to ``eps``
    (more phases than ``phases`` when the ratio needs them); with ``theta``
    the schedule is the fixed ladder eps theta^p, p = phases - 1 .. 0,
    instead. Each phase restarts the assignment and keeps the prices. The
    final phase gets ``final_iters`` rounds (default 10x ``iters``), run in
    segments of ``iters`` that carry the prices and the partial bijection,
    with a check for completion between segments; then the bidders still
    unassigned are matched to the free objects exactly by scipy's
    Hungarian solver, so the result is a full permutation. With one phase
    (``final_iters`` rounds, default ``iters``), bidders left unassigned
    take their nearest target (duplicates possible).

    At N >= 32,768 and B > 1 the JAX package solves the items one at a
    time. Its result is then each item's own: with eps scaling the
    schedule is anchored at that item's cloud, so the port splits there
    too. With one phase the items' auctions are independent and the
    whole batch gives the same assignment, so the port keeps one batched
    solve (one host read a round, not B).

    x, y: [B, N, 3]. Returns [B, N] int64.
    """
    b, n, _ = x.shape
    if n >= SPLIT_ITEMS_AT and b > 1 and phases > 1:
        return torch.cat([auction_assignment(x[i:i + 1], y[i:i + 1], eps,
                                             iters, phases, theta, final_iters)
                          for i in range(b)])
    x, y = x.detach().float(), y.detach().float()
    price = torch.zeros((b, n), dtype=torch.float32, device=x.device)
    if final_iters is None:
        final_iters = 10 * iters if phases > 1 else iters
    if phases <= 1:
        schedule = [eps]
    elif theta is not None:
        schedule = [eps * theta ** p for p in range(phases - 1, -1, -1)]
    else:
        lo = torch.minimum(x.amin((0, 1)), y.amin((0, 1)))
        hi = torch.maximum(x.amax((0, 1)), y.amax((0, 1)))
        eps0 = float(torch.clamp_min(((hi - lo) ** 2).sum() / 4.0, eps))
        ratio = eps0 / eps
        nph = max(phases, 1 + int(np.ceil(np.log(max(ratio, 1.0))
                                          / np.log(_THETA))))
        schedule = [eps * ratio ** (p / max(nph - 1, 1))
                    for p in range(nph - 1, -1, -1)]
    assign = None
    for i, eps_p in enumerate(schedule):
        if i < len(schedule) - 1:
            price, assign = _auction_phase(x, y, price, eps_p, iters)
            continue
        remaining = int(final_iters)
        assign = None          # the first segment re-auctions at the final eps
        while remaining > 0:
            seg = min(int(iters), remaining)
            price, assign = _auction_phase(x, y, price, eps_p, seg,
                                           assign0=assign)
            remaining -= seg
            if not bool((assign < 0).any()):
                break
    if phases > 1:
        return _repair_assignment_tail(x, y, assign)
    _, nn_idx = nearest_neighbor(x, y)
    return torch.where(assign < 0, nn_idx, assign)


def _repair_assignment_tail(x: torch.Tensor, y: torch.Tensor,
                            assign: torch.Tensor) -> torch.Tensor:
    """Match the auction's unassigned bidders to the unclaimed objects
    exactly (scipy's Hungarian solver on the host), so the assignment is a
    full permutation. Claims after the first on one object, which a partial
    bijection never holds, are demoted to unassigned first."""
    from scipy.optimize import linear_sum_assignment

    a = assign.cpu().numpy().copy()
    xs, ys = x.cpu().numpy(), y.cpu().numpy()
    n = a.shape[1]
    for bi in range(a.shape[0]):
        ab = a[bi]
        pos = np.where(ab >= 0)[0]
        _, first = np.unique(ab[pos], return_index=True)
        if first.size != pos.size:
            dup = np.ones(pos.size, dtype=bool)
            dup[first] = False
            ab[pos[dup]] = -1
        miss = np.where(ab < 0)[0]
        if miss.size == 0:
            continue
        free = np.setdiff1d(np.arange(n), ab[ab >= 0])
        # index in two steps: ys[bi, None, free] would move the advanced
        # index's dimension to the front and repair one bidder only
        d = xs[bi, miss][:, None, :] - ys[bi, free][None, :, :]
        r, c = linear_sum_assignment(np.einsum("ijk,ijk->ij", d, d))
        ab[miss[r]] = free[c]
    return torch.from_numpy(a).to(assign.device)


def emd_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 0.05,
             iters: int = 100, phases: int = 1) -> torch.Tensor:
    """Earth mover's distance under the auction assignment, computed
    without gradient: the sum of euclidean distances to the assigned
    targets, differentiable in the coordinates. [B, N, 3] x2 -> [B]."""
    with torch.no_grad():
        assign = auction_assignment(pred, target, eps, iters, phases=phases)
    matched = torch.gather(target, 1, assign[..., None].expand(-1, -1, 3))
    d2 = ((pred - matched) ** 2).sum(-1)
    return torch.sqrt(torch.clamp_min(d2, 1e-20)).sum(-1)


def gaussian_mmd(x: torch.Tensor, y: torch.Tensor, blur: float = 0.05
                 ) -> torch.Tensor:
    """Gaussian-kernel MMD between two point sets, the geomloss form the
    reference evaluates: 0.5 (E k(x, x') + E k(y, y')) - E k(x, y) with
    k = exp(-|d|^2 / (2 blur^2)). x [B, N, 3], y [B, M, 3] -> [B].

    Each mean is taken over blocks of query rows (f32 block sums added in
    f64), so no [N, M] kernel matrix sits whole in memory."""
    g = 1.0 / (2.0 * blur * blur)

    def mean_k(a, c):
        total = torch.zeros(a.shape[0], dtype=torch.float64, device=a.device)
        for s in range(0, a.shape[1], _CHUNK):
            blk = torch.exp(-g * pairwise_sqdist(a[:, s:s + _CHUNK], c))
            total += blk.sum((-1, -2)).double()
        return total / (a.shape[1] * c.shape[1])

    return (0.5 * (mean_k(x, x) + mean_k(y, y)) - mean_k(x, y)).float()
