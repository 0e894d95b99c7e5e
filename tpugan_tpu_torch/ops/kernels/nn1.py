"""Streaming 1-NN: the CUDA kernel ``csrc/nn1.cu`` and its plain PyTorch
version.

Replaces ``tpugan_tpu/ops/pallas/nn1_kernel.py : nn1_pallas``. The kernel's
source note says what bounds it on the card and how it is laid out;
:func:`nn1_plan` picks its shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of
from tpugan_tpu_torch.ops.kernels.knn import sqdist

KERNEL = CudaKernel("nn1", {"nn1_f32": [VOIDP] * 5 + [INT] * 6 + [VOIDP]})

_PLAIN_CHUNK = 2048   # query rows per [rows, M] block in the plain version

# The shapes nn1.cu admits (its entry point refuses others):
CHUNK = 32                  # candidates between two argmin records
QPT = 4                     # queries a thread
THREADS_MAX = 256           # threads a block, a multiple of 32
MAX_ROWS = 2 ** 31 - 1      # B * Nq and M (32-bit indices)

# The plan's choices (tools/nn1_plan_sweep_torch.py on an H100 SXM, PERF.md):
# the widest block of THREADS that still gives MIN_QUERY_BLOCKS blocks of
# queries (256 threads beat 128 at 4 x 9,216, tied at one row); then the
# candidate split whose launch is cheapest by the model of _plan_cost:
# equal blocks share the card's SMs, so an SM's time is the work of the
# most blocks any SM runs, ceil(blocks / SMs); a block's work is its
# queries times (its span + OVERHEAD), OVERHEAD standing for the rescan,
# the merge and the tile's load; an SM with fewer than SAT_THREADS threads
# issues at a share of its rate. Spans between one and four tiles are left
# out (the first tiles' chunks are rescanned from device memory). The
# simpler rule, the fewest splits that give two blocks an SM, lost to it at
# every main-path shape (1.85x at 4 x 9,216; PERF.md).
THREADS = (256, 128, 64)
MIN_QUERY_BLOCKS = 16
SAT_THREADS = 256
OVERHEAD = 160
TILE = 1024                 # candidates a shared-memory tile (nn1.cu)
MAX_SPLITS = 64
MIN_SPAN = 256


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Nn1Plan:
    """A launch of ``nn1.cu``: blocks of ``threads`` threads, QPT queries a
    thread (thread t of query block g holds queries g * threads * QPT +
    u * threads + t, u < QPT), the candidates cut into ``splits`` ranges of
    ``span`` (the last one shorter)."""
    threads: int
    splits: int
    span: int

    @property
    def queries(self) -> int:
        """Queries a block."""
        return self.threads * QPT

    def q_blocks(self, nq: int) -> int:
        return _ceil(nq, self.queries)

    def blocks(self, b: int, nq: int) -> int:
        """The launch's grid."""
        return b * self.splits * self.q_blocks(nq)

    def admits(self, nq: int, m: int) -> bool:
        """Whether ``nn1.cu`` takes this shape for Nq queries over M
        candidates: every split holds at least one candidate."""
        return (self.threads % 32 == 0 and 32 <= self.threads <= THREADS_MAX
                and self.span >= CHUNK
                and self.span % CHUNK == 0 and nq >= 1 and m >= 1
                and (self.splits - 1) * self.span < m <= self.splits * self.span)


def _even_threads(nq: int, threads: int) -> Tuple[int, int]:
    """(threads, query blocks): as many blocks as ``threads`` needs, their
    threads as few as still cover Nq (a multiple of 32)."""
    qb = _ceil(nq, threads * QPT)
    return 32 * _ceil(nq, 32 * QPT * qb), qb


def _plan_cost(b: int, qb: int, threads: int, span: int, splits: int,
               sms: int) -> float:
    """The model the plan minimises (see the constants above)."""
    per_sm = _ceil(b * qb * splits, sms)
    share = min(1.0, per_sm * threads / SAT_THREADS)
    return per_sm * threads * QPT * (span + OVERHEAD) / share


def nn1_plan(b: int, nq: int, m: int, sms: int) -> Nn1Plan:
    """The kernel's launch for ``b`` rows of ``nq`` queries over ``m``
    candidates on a card of ``sms`` SMs (see the constants above); on a tie
    of the model, the fewer splits."""
    if (b < 0 or nq < 0 or not 1 <= m <= MAX_ROWS or b * nq > MAX_ROWS
            or sms < 1):
        raise ValueError(f"nn1 kernel: B={b}, Nq={nq}, M={m}, {sms} SMs")
    b, nq, chunks = max(b, 1), max(nq, 1), _ceil(m, CHUNK)
    width = next((t for t in THREADS
                  if b * _ceil(nq, t * QPT) >= MIN_QUERY_BLOCKS), THREADS[-1])
    threads, qb = _even_threads(nq, width)
    best = None
    for want in range(1, min(MAX_SPLITS, chunks) + 1):
        span = CHUNK * _ceil(chunks, want)
        splits = _ceil(m, span)
        if splits > 1 and (span < MIN_SPAN or TILE < span < 4 * TILE):
            continue
        key = (_plan_cost(b, qb, threads, span, splits, sms), splits)
        if best is None or key < best[0]:
            best = (key, Nn1Plan(threads, splits, span))
    return best[1]


def nn1_plain(query: torch.Tensor, cand: torch.Tensor, bias: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: same formula, and ``min``
    returns the first (lowest) index among equal values."""
    ds, idxs = [], []
    for s in range(0, query.shape[1], _PLAIN_CHUNK):
        d2 = sqdist(query[:, s:s + _PLAIN_CHUNK], cand) + bias[:, None, :]
        d, i = torch.min(d2, dim=-1)
        ds.append(d)
        idxs.append(i)
    return torch.cat(ds, 1), torch.cat(idxs, 1)


def nn1_kernel(query: torch.Tensor, cand: torch.Tensor, bias: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest candidate per query: (d2 [B, Nq] f32, idx [B, Nq] int64).

    query [B, Nq, 3] f32, cand [B, M, 3] f32, bias [B, M] f32 (0 valid,
    1e10 invalid), M >= 1. A CPU tensor takes :func:`nn1_plain`; a CUDA
    tensor launches the kernel, planned by :func:`nn1_plan`, or raises.
    """
    b, nq, d = query.shape
    m = cand.shape[1]
    if d != 3 or cand.shape != (b, m, 3) or bias.shape != (b, m) or m < 1:
        raise ValueError(f"nn1: shapes {tuple(query.shape)}, "
                         f"{tuple(cand.shape)}, {tuple(bias.shape)}")
    if query.device.type == "cpu":
        return nn1_plain(query, cand, bias)
    if not query.is_cuda or cand.device != query.device or bias.device != query.device:
        raise ValueError(f"nn1: tensors on {query.device}, {cand.device}, "
                         f"{bias.device}")
    if {query.dtype, cand.dtype, bias.dtype} != {torch.float32}:
        raise TypeError("nn1 kernel takes float32 query, cand and bias")
    sms = torch.cuda.get_device_properties(query.device).multi_processor_count
    return _launch(query, cand, bias, nn1_plan(b, nq, m, sms))


def _launch(query: torch.Tensor, cand: torch.Tensor, bias: torch.Tensor,
            plan: Nn1Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nn1_kernel`'s launch under ``plan`` (CUDA float32 tensors of
    its shapes); the plan sweep and the card tests force other plans here."""
    b, nq = query.shape[:2]
    m = cand.shape[1]
    if not plan.admits(nq, m) and b * nq:
        raise ValueError(f"nn1 kernel: {plan} does not cover Nq={nq}, M={m}")
    query, cand, bias = query.contiguous(), cand.contiguous(), bias.contiguous()
    d2 = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq), dtype=torch.int64, device=query.device)
    if b * nq == 0:
        return d2, idx
    KERNEL.launch("nn1_f32", ptr(query), ptr(cand), ptr(bias), ptr(d2),
                  ptr(idx), b, nq, m, plan.threads, plan.splits, plan.span,
                  stream_of(query))
    return d2, idx
