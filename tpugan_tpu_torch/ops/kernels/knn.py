"""kNN: the CUDA kernels of ``csrc/knn.cu`` and their plain PyTorch versions.

Replaces ``tpugan_tpu/ops/pallas/knn_kernel.py : knn_pallas``: the exact
search (``knn_f32``, :func:`knn_kernel`) and the approximate bf16 mode of
``approx=True`` (``knn_approx_bf16``, :func:`knn_approx_kernel`). The
kernels' source note says what bounds them on the card and how they are
laid out.

The approximate mode's contract, where :func:`takes_approx` holds (the
shapes at which the TPU kernel runs its bf16 body): each candidate c of a
query q gets the 32-bit key

    bits(bf16(max(|q|^2 + |c|^2 - 2 bf16(q).bf16(c), 0) + bias)) << 16 | c

(norms from the f32 operands, the cross term from the bf16-rounded ones
accumulated in f32, one round-to-nearest-even to bf16 at the end); of the
candidates c = l (mod 128) of each lane column l the kp smallest keys are
kept (kp from :func:`chunk_kp_approx`), and of those 128 kp keys the k
smallest are the result: d2 is the bf16 value as f32, idx the low half.
The TPU kernel's folds break ties toward the lower tile and its merge
toward the lower index, both the key's order; a query whose true top-k
holds more than kp members of one lane column loses the rest, as there.
``KERNEL.launches`` counts the exact kernel's launches and
``APPROX.launches`` the approximate one's; :func:`knn_approx_plan` picks the
approximate kernel's block shape.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("knn", {"knn_f32": [VOIDP] * 5 + [INT] * 5 + [VOIDP]})
APPROX = CudaKernel("knn", {"knn_approx_bf16": [VOIDP] * 6 + [ctypes.c_longlong]
                            + [INT] * 7 + [VOIDP]})

MAX_D = 64      # widest point / feature vector the kernel is compiled for
MAX_K = 32      # largest k bucket the kernel is compiled for at any D
MAX_K_POINTS = 64   # the k = 64 bucket, built for D <= 4 (points) only
_PLAIN_CHUNK = 2048   # query rows per [rows, Nc] block in the plain version

# The TPU kernel's dispatch, copied from tpugan_tpu/ops/pallas/knn_kernel.py
# (_CHUNK_L, _CHUNK_MIN_NC, _use_chunked, _chunk_kp_approx) and
# tpugan_tpu/ops/neighbors.py (_PALLAS_MAX_NC)
LANES = 128             # lane columns: candidate c lies in column c % 128
APPROX_MIN_NC = 4096    # below this the TPU kernel runs its exact plain peel
PALLAS_MAX_NC = 24576   # above this the JAX kNN takes no TPU kernel at all
_APPROX_CHUNK = 512     # query rows per block in the plain approximate version


def sqdist(query: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[..., Nq, D] x [..., Nc, D] -> [..., Nq, Nc]:
    ``max(|q|^2 + |c|^2 - 2 q.c, 0)``, the distance every kernel computes."""
    q2 = (query * query).sum(-1, keepdim=True)
    c2 = (cand * cand).sum(-1, keepdim=True)
    d2 = q2 + c2.transpose(-1, -2) - 2.0 * torch.matmul(
        query, cand.transpose(-1, -2))
    return d2.clamp_min(0.0)


def knn_plain(query: torch.Tensor, cand: torch.Tensor, bias: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (same formula, same tie rule:
    a stable sort orders equal distances by candidate index)."""
    ds, idxs = [], []
    for s in range(0, query.shape[1], _PLAIN_CHUNK):
        d2 = sqdist(query[:, s:s + _PLAIN_CHUNK], cand) + bias[:, None, :]
        d, i = torch.sort(d2, dim=-1, stable=True)
        ds.append(d[..., :k])
        idxs.append(i[..., :k])
    return torch.cat(ds, 1), torch.cat(idxs, 1)


def knn_kernel(query: torch.Tensor, cand: torch.Tensor, bias: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN, ascending: (d2 [B, Nq, k] f32, idx [B, Nq, k] int64).

    query [B, Nq, D] f32, cand [B, Nc, D] f32, bias [B, Nc] f32 (0 valid,
    1e10 invalid), 1 <= k <= Nc. A CPU tensor takes :func:`knn_plain`; a
    CUDA tensor launches the kernel or raises.
    """
    b, nq, d = query.shape
    nc = cand.shape[1]
    if cand.shape != (b, nc, d) or bias.shape != (b, nc):
        raise ValueError(f"knn: shapes {tuple(query.shape)}, "
                         f"{tuple(cand.shape)}, {tuple(bias.shape)}")
    if not 1 <= k <= nc:
        raise ValueError(f"knn: k={k} outside [1, Nc={nc}]")
    if query.device.type == "cpu":
        return knn_plain(query, cand, bias, k)
    if not query.is_cuda or cand.device != query.device or bias.device != query.device:
        raise ValueError(f"knn: tensors on {query.device}, {cand.device}, "
                         f"{bias.device}")
    if {query.dtype, cand.dtype, bias.dtype} != {torch.float32}:
        raise TypeError("knn kernel takes float32 query, cand and bias")
    if d > MAX_D or k > (MAX_K_POINTS if d <= 4 else MAX_K):
        raise ValueError(f"knn kernel is built for D <= {MAX_D}, k <= {MAX_K} "
                         f"(k <= {MAX_K_POINTS} for D <= 4); got D={d}, k={k}")
    query, cand, bias = query.contiguous(), cand.contiguous(), bias.contiguous()
    d2 = torch.empty((b, nq, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq, k), dtype=torch.int64, device=query.device)
    if b * nq == 0:
        return d2, idx
    KERNEL.launch("knn_f32", ptr(query), ptr(cand), ptr(bias), ptr(d2),
                  ptr(idx), b, nq, nc, d, k, stream_of(query))
    return d2, idx


# ---------------------------------------------------------- approximate mode

def chunk_kp_approx(k: int) -> int:
    """Keys kept per lane column in the approximate mode."""
    return 3 if k >= 16 else 2


def takes_approx(nc: int, k: int) -> bool:
    """Whether the TPU kernel runs its approximate bf16 body for ``nc``
    candidates and ``k`` neighbours (its chunked path; elsewhere its
    ``approx`` changes nothing). The JAX kNN adds ``nc <= PALLAS_MAX_NC``."""
    return nc >= APPROX_MIN_NC and nc % LANES == 0 and k >= 3


def _approx_keys(query: torch.Tensor, cand: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """[B, Nq, Nc] int64 keys of the approximate contract (module note)."""
    q2 = (query * query).sum(-1, keepdim=True)
    c2 = (cand * cand).sum(-1, keepdim=True)
    cross = torch.matmul(query.bfloat16().float(),
                         cand.bfloat16().float().transpose(-1, -2))
    d2 = (q2 + c2.transpose(-1, -2) - 2.0 * cross).clamp_min(0.0) \
        + bias[:, None, :]
    bits = d2.bfloat16().view(torch.int16).to(torch.int64) & 0xFFFF
    idx = torch.arange(cand.shape[1], device=cand.device)
    return (bits << 16) | idx


def knn_approx_plain(query: torch.Tensor, cand: torch.Tensor,
                     bias: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The approximate kernel's function in plain PyTorch (module note)."""
    b, _, _ = query.shape
    nc = cand.shape[1]
    kp = chunk_kp_approx(k)
    ds, idxs = [], []
    for s in range(0, query.shape[1], _APPROX_CHUNK):
        keys = _approx_keys(query[:, s:s + _APPROX_CHUNK], cand, bias)
        rows = keys.shape[1]
        cols = keys.view(b, rows, nc // LANES, LANES)
        kept = torch.topk(cols, kp, dim=2, largest=False).values
        best = torch.topk(kept.reshape(b, rows, kp * LANES), k, dim=-1,
                          largest=False, sorted=True).values
        bits = (best >> 16).to(torch.int32).to(torch.int16)
        ds.append(bits.view(torch.bfloat16).float())
        idxs.append(best & 0xFFFF)
    return torch.cat(ds, 1), torch.cat(idxs, 1)


def _pre_round(query, cand, bias, bi, qi, ci):
    """float64 max(|q|^2 + |c|^2 - 2 bf16(q).bf16(c), 0) + bias at the
    (batch, query, candidate) index tensors: the value the contract rounds."""
    q, c = query[bi, qi].double(), cand[bi, ci].double()
    dot = (query[bi, qi].bfloat16().double() * cand[bi, ci].bfloat16().double()
           ).sum(-1)
    v = (q * q).sum(-1) + (c * c).sum(-1) - 2.0 * dot
    return v.clamp_min(0.0) + bias[bi, ci].double()


def approx_agreement(got, want, got_in, want_in=None) -> dict:
    """How two approximate results (d2, idx) [B, Nq, k] agree, each from
    its inputs (query, cand, bias) (``want_in`` defaults to ``got_in``).

    The sides round |q|^2 + |c|^2 - 2 q.c in f32 in other orders, within
    ``tol`` = 1e-5 * 2 max |p|^2 (inputs that differ by f32 noise, as two
    forwards' features do, may also round a bf16 operand apart). So a
    distance whose value lies within ``tol`` of a bf16 rounding boundary may
    round to either side of it. Returns the largest excess of a side's d2
    over half a bf16 ulp plus ``tol`` from the float64 value (``d2_excess``,
    <= 0 when right), the entries of equal index and unequal d2 with no such
    cause (``d2_unexplained``), the queries whose lists differ (``rows``)
    and those with no candidate among both sides' neighbours that rounds
    apart (``rows_unexplained``), and the query count (``queries``)."""
    want_in = got_in if want_in is None else want_in
    got_in, want_in = ([t.detach().cpu() for t in x] for x in (got_in, want_in))
    (gd, gi), (wd, wi) = ([t.detach().cpu() for t in x] for x in (got, want))
    tol = 1e-5 * 2 * max(float((x.double() ** 2).sum(-1).max())
                         for x in (*got_in[:2], *want_in[:2]))
    b, nq, k = wi.shape
    bi = torch.arange(b)[:, None, None].expand(b, nq, 2 * k)
    qi = torch.arange(nq)[None, :, None].expand(b, nq, 2 * k)
    both = torch.cat([gi, wi], -1)
    rounded, near, excess = [], [], []
    for d2, inputs, part in ((gd, got_in, slice(0, k)),
                             (wd, want_in, slice(k, 2 * k))):
        v = _pre_round(*inputs, bi, qi, both)
        half = torch.exp2(torch.floor(torch.log2(v.clamp_min(1e-30))) - 8)
        slack = tol + v * 2.0 ** -23
        r = v.float().bfloat16().double()
        rounded.append(r)
        near.append((v - r).abs() >= half - slack)
        excess.append(float(((d2.double() - v[..., part]).abs()
                             - half[..., part] - slack[..., part]).max()))
    apart = near[0] | near[1] | (rounded[0] != rounded[1])
    same = gi == wi
    rows = ~same.all(-1)
    return {"d2_excess": max(excess),
            "d2_unexplained": int((same & (gd != wd) & ~apart[..., :k]).sum()),
            "rows": int(rows.sum()),
            "rows_unexplained": int((rows & ~apart.any(-1)).sum()),
            "queries": b * nq}


# The approximate kernel's launch shapes (csrc/knn.cu : approx): a block
# holds WQ query tiles of 16 rows (128 WQ threads), and its instance's
# launch bounds keep APPROX_BLOCKS_PER_SM[WQ] blocks resident on an SM (128
# and 96 registers a thread). The plan takes the instance whose busiest
# SM has the least work: blocks spread evenly over the SMs, an SM runs its
# blocks in waves of APPROX_BLOCKS_PER_SM, and a wave costs its queries but
# at least APPROX_SAT_QUERIES (an SM with fewer resident queries issues at a
# share of its rate); on a tie the fewer blocks (each block reads every
# candidate row from L2).
APPROX_BLOCKS_PER_SM = {2: 2, 5: 1}
APPROX_SAT_QUERIES = 32
APPROX_MAX_ROWS = 65535     # B, the grid's second dimension


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ApproxPlan:
    """A launch of the approximate kernel: ``wq`` query tiles of 16 a block
    (16 wq queries, 128 wq threads)."""
    wq: int

    @property
    def queries(self) -> int:
        return 16 * self.wq

    @property
    def threads(self) -> int:
        return 128 * self.wq

    @property
    def per_sm(self) -> int:
        """Blocks an SM holds (the instance's launch bounds)."""
        return APPROX_BLOCKS_PER_SM[self.wq]

    def blocks(self, b: int, nq: int) -> int:
        """The launch's grid."""
        return b * _ceil(nq, self.queries)

    def waves(self, b: int, nq: int, sms: int) -> int:
        """Rounds of resident blocks the busiest SM runs."""
        return _ceil(_ceil(self.blocks(b, nq), sms), self.per_sm)

    def admits(self) -> bool:
        return self.wq in APPROX_BLOCKS_PER_SM


def _approx_cost(plan: ApproxPlan, b: int, nq: int, sms: int) -> int:
    """The work of the busiest SM by the model above, in queries."""
    left, cost = _ceil(plan.blocks(b, nq), sms), 0
    while left > 0:
        wave = min(left, plan.per_sm)
        cost += max(wave * plan.queries, APPROX_SAT_QUERIES)
        left -= wave
    return cost


@functools.lru_cache(maxsize=256)
def knn_approx_plan(b: int, nq: int, nc: int, d: int, k: int,
                    sms: int) -> ApproxPlan:
    """The approximate kernel's launch for ``b`` rows of ``nq`` queries over
    ``nc`` candidates of width ``d`` on a card of ``sms`` SMs (the model
    above)."""
    if (not 1 <= b <= APPROX_MAX_ROWS or nq < 1 or not 1 <= d <= MAX_D
            or sms < 1 or not (takes_approx(nc, k) and nc <= 0xFFFF
                               and k <= chunk_kp_approx(k) * LANES)):
        raise ValueError(f"knn approx kernel: B={b}, Nq={nq}, Nc={nc}, D={d}, "
                         f"k={k}, {sms} SMs")
    plans = [ApproxPlan(wq) for wq in sorted(APPROX_BLOCKS_PER_SM)]
    return min(plans, key=lambda p: (_approx_cost(p, b, nq, sms),
                                     p.blocks(b, nq)))


def approx_dk(d: int) -> int:
    """Features of the kernel's bf16 rows: D padded to 16, 32 or 64."""
    return 16 if d <= 16 else 32 if d <= 32 else 64


def approx_scratch_bytes(b: int, nq: int, nc: int, d: int, self_graph: bool
                         ) -> int:
    """The kernel's scratch: bf16 candidate rows and (|c|^2, bias), then
    (not for a self graph) bf16 query rows and |q|^2, each from a 16-byte
    boundary (csrc/knn.cu : approx::launch)."""
    a16 = lambda x: -(-x // 16) * 16
    dk = approx_dk(d)
    out = a16(b * nc * dk * 2) + a16(b * nc * 8)
    return out if self_graph else out + a16(b * nq * dk * 2) + a16(b * nq * 4)


def knn_approx_kernel(query: torch.Tensor, cand: torch.Tensor,
                      bias: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate bf16 kNN, ascending: (d2 [B, Nq, k] f32, idx [B, Nq, k]
    int64), for shapes where :func:`takes_approx` holds (the caller
    dispatches; other shapes raise). Inputs as :func:`knn_kernel`'s. A CPU
    tensor takes :func:`knn_approx_plain`; a CUDA tensor launches the
    kernel, planned by :func:`knn_approx_plan`, or raises."""
    b, nq, d = query.shape
    nc = cand.shape[1]
    if cand.shape != (b, nc, d) or bias.shape != (b, nc):
        raise ValueError(f"knn approx: shapes {tuple(query.shape)}, "
                         f"{tuple(cand.shape)}, {tuple(bias.shape)}")
    if not (takes_approx(nc, k) and nc <= 0xFFFF
            and k <= chunk_kp_approx(k) * LANES):
        raise ValueError(f"knn approx: Nc={nc}, k={k} is not an approximate "
                         f"shape (takes_approx, and Nc < 2^16 for the keys)")
    if query.device.type == "cpu":
        return knn_approx_plain(query, cand, bias, k)
    if not query.is_cuda or cand.device != query.device or bias.device != query.device:
        raise ValueError(f"knn approx: tensors on {query.device}, "
                         f"{cand.device}, {bias.device}")
    if {query.dtype, cand.dtype, bias.dtype} != {torch.float32}:
        raise TypeError("knn approx kernel takes float32 query, cand and bias")
    if d > MAX_D or b > APPROX_MAX_ROWS:
        raise ValueError(f"knn approx kernel is built for D <= {MAX_D}, "
                         f"B <= {APPROX_MAX_ROWS}; got D={d}, B={b}")
    if b * nq == 0:
        return (torch.empty((b, nq, k), dtype=torch.float32, device=query.device),
                torch.empty((b, nq, k), dtype=torch.int64, device=query.device))
    sms = torch.cuda.get_device_properties(query.device).multi_processor_count
    return _launch_approx(query, cand, bias, k,
                          knn_approx_plan(b, nq, nc, d, k, sms))


def _launch_approx(query: torch.Tensor, cand: torch.Tensor,
                   bias: torch.Tensor, k: int, plan: ApproxPlan
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_approx_kernel`'s launch under ``plan`` (CUDA float32
    tensors of its shapes, B Nq >= 1); the plan sweep and the card tests
    force other plans here."""
    b, nq, d = query.shape
    nc = cand.shape[1]
    if not plan.admits():
        raise ValueError(f"knn approx kernel: {plan} not built")
    query, cand, bias = query.contiguous(), cand.contiguous(), bias.contiguous()
    self_graph = query.data_ptr() == cand.data_ptr() and nq == nc
    d2 = torch.empty((b, nq, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq, k), dtype=torch.int64, device=query.device)
    nbytes = approx_scratch_bytes(b, nq, nc, d, self_graph)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=query.device)
    APPROX.launch("knn_approx_bf16", ptr(query), ptr(cand), ptr(bias),
                  ptr(d2), ptr(idx), ptr(scratch), nbytes, b, nq, nc, d, k,
                  chunk_kp_approx(k), plan.wq, stream_of(query))
    return d2, idx
