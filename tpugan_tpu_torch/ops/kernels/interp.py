"""Dense SPH-kernel interpolation: the CUDA kernel ``csrc/interp.cu`` and its
plain PyTorch version.

Replaces ``tpugan_tpu/ops/pallas/interp_kernel.py : kernel_interp_pallas``
(and ``chunked_dense_interp``'s candidate chunks, which the card does not
need). The kernel's source note says what bounds it on the card and how it
is laid out; :func:`interp_plan` picks its shape.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("interp", {
    "interp_f32": [VOIDP] * 7 + [INT] * 7 + [ctypes.c_float] * 4
    + [INT, VOIDP]})

KINDS = {"bicubic": 0, "spline1": 1, "linear": 2, "exponential": 3}
MAX_C = 8
_PLAIN_CHUNK = 1024   # query rows per [rows, M] block in the plain version

# The shapes interp.cu admits (its entry point refuses others):
QPT = 2                     # queries a thread (2 beat 1 and 4 on the card)
THREADS_MAX = 256           # threads a block, a multiple of 32
MAX_ROWS = 2 ** 31 - 1      # B * Nq and M (32-bit indices)

# The plan's choices (tools/nn1_plan_sweep_torch.py on an H100 SXM, PERF.md):
# blocks of up to THREADS threads, and candidate splits of SPAN, at most
# MAX_SPLITS. At 12 x 9,216 (C = 3) the train step's own call ran fastest
# at spans of 256 (the blocks' work depends on the data, and many small
# blocks even it out; each split adds a partial of C + 1 floats a query to
# write and add).
THREADS = 128
SPAN = 256
MAX_SPLITS = 64


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class InterpPlan:
    """A launch of ``interp.cu``: blocks of ``threads`` threads, QPT queries
    a thread (thread t of query block g holds queries g * threads * QPT +
    u * threads + t, u < QPT), the candidates cut into ``splits`` ranges of
    ``span`` (the last one shorter), their partial sums added in split
    order."""
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

    def admits(self, nq: int, m: int, c: int) -> bool:
        """Whether ``interp.cu`` takes this shape for Nq queries over M
        candidates of C values: every split holds at least one candidate."""
        return (self.threads % 32 == 0 and 32 <= self.threads <= THREADS_MAX
                and 1 <= c <= MAX_C and self.span >= 1
                and nq >= 1 and m >= 1
                and (self.splits - 1) * self.span < m <= self.splits * self.span)


def interp_plan(b: int, nq: int, m: int, c: int) -> InterpPlan:
    """The kernel's launch for ``b`` rows of ``nq`` queries over ``m``
    candidates of ``c`` values."""
    if (b < 0 or nq < 0 or not 1 <= m <= MAX_ROWS or b * nq > MAX_ROWS
            or not 1 <= c <= MAX_C):
        raise ValueError(f"interp kernel: B={b}, Nq={nq}, M={m}, C={c}")
    nq = max(nq, 1)
    threads = min(THREADS, 32 * _ceil(nq, 32 * QPT))
    qb = _ceil(nq, threads * QPT)
    threads = 32 * _ceil(nq, 32 * QPT * qb)      # the same blocks, even
    span = 32 * _ceil(_ceil(m, min(MAX_SPLITS, _ceil(m, SPAN))), 32)
    return InterpPlan(threads, _ceil(m, span), span)


def kernel_constants(cutoff: float, kind: str) -> Tuple[float, float, float]:
    """(1 / cutoff^2, k1, k2) of the two-hinge weight, computed in double as
    the TPU kernel's ``_kernel_w`` computes its Python constants."""
    inv_c2 = 1.0 / (float(cutoff) * float(cutoff))
    if kind in ("bicubic", "spline1"):
        coeff = 8.0 / (math.pi * cutoff ** 3) if kind == "bicubic" else 1.0
        return inv_c2, 2.0 * coeff, 8.0 * coeff
    if kind == "linear":
        return inv_c2, 0.0, 0.0
    if kind == "exponential":
        return inv_c2, 1.0 / (math.pi ** 1.5) * cutoff ** 3, 0.0
    raise ValueError(f"unknown kernel {kind!r}")


def d2_threshold(cutoff: float) -> float:
    """The largest f32 d2 whose u = d2 * (1 / cutoff^2), rounded to f32 as
    the kernels round it, is at most 1: every kind weighs a pair whose d2
    exceeds it +0 (``interp.cu`` skips those pairs)."""
    inv = np.float32(kernel_constants(cutoff, "linear")[0])
    one, x = np.float32(1), np.float32(1) / inv
    while x * inv > one:
        x = np.nextafter(x, np.float32(0))
    while np.nextafter(x, np.float32(np.inf)) * inv <= one:
        x = np.nextafter(x, np.float32(np.inf))
    return float(x)


def sph_weight(d2: torch.Tensor, cutoff: float, kind: str) -> torch.Tensor:
    """The SPH weight of a squared distance (zero beyond the cutoff)."""
    inv_c2, k1, k2 = kernel_constants(cutoff, kind)
    u = torch.clamp_min(d2 * inv_c2, 0.0)
    q = torch.sqrt(u)
    if kind == "linear":
        return torch.clamp_min(1.0 - q, 0.0)
    if kind == "exponential":
        return torch.where(u <= 1.0, k1 * torch.exp(-u), 0.0)
    s1 = torch.clamp_min(1.0 - q, 0.0)
    s2 = torch.clamp_min(0.5 - q, 0.0)
    return k1 * (s1 * s1 * s1) - k2 * (s2 * s2 * s2)


def sq_dist(diff: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """((dx*dx + dy*dy) + dz*dz) + bias of differences [..., 3], in the
    kernels' order (``csrc/sph_weight.cuh : sph_d2``): near the cutoff one
    ulp of d2 moves the weight by about 1e-4 of itself."""
    sq = diff * diff
    return ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + bias


def interp_plain(query: torch.Tensor, cand: torch.Tensor, values: torch.Tensor,
                 cutoff: float, bias: torch.Tensor, kind: str = "bicubic"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (query chunks of [rows, M])."""
    outs, dens = [], []
    for s in range(0, query.shape[1], _PLAIN_CHUNK):
        diff = query[:, s:s + _PLAIN_CHUNK, None, :] - cand[:, None, :, :]
        d2 = sq_dist(diff, bias[:, None, :])
        w = sph_weight(d2, cutoff, kind)
        den = w.sum(-1) + 1e-6
        outs.append(torch.matmul(w, values) / den[..., None])
        dens.append(den)
    return torch.cat(outs, 1), torch.cat(dens, 1)


def interp_kernel(query: torch.Tensor, cand: torch.Tensor,
                  values: torch.Tensor, cutoff: float, bias: torch.Tensor,
                  kind: str = "bicubic"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Nq, C], den [B, Nq]): out = sum_c w values / den,
    den = sum_c w + 1e-6, over every candidate.

    query [B, Nq, 3], cand [B, M, 3], values [B, M, C], bias [B, M] (0
    valid, 1e10 invalid), all f32. A CPU tensor takes :func:`interp_plain`;
    a CUDA tensor launches the kernel, planned by :func:`interp_plan`, or
    raises.
    """
    b, nq, d = query.shape
    m, c = cand.shape[1], values.shape[-1]
    if (d != 3 or cand.shape != (b, m, 3) or values.shape != (b, m, c)
            or bias.shape != (b, m)):
        raise ValueError(f"interp: shapes {tuple(query.shape)}, "
                         f"{tuple(cand.shape)}, {tuple(values.shape)}, "
                         f"{tuple(bias.shape)}")
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if m < 1:
        raise ValueError("interp: no candidates")
    if query.device.type == "cpu":
        return interp_plain(query, cand, values, cutoff, bias, kind)
    if not query.is_cuda or any(t.device != query.device
                                for t in (cand, values, bias)):
        raise ValueError("interp: tensors on more than one device")
    if {query.dtype, cand.dtype, values.dtype, bias.dtype} != {torch.float32}:
        raise TypeError("interp kernel takes float32 tensors")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"interp kernel takes 1 <= C <= {MAX_C}; got {c}")
    return _launch(query, cand, values, cutoff, bias, kind,
                   interp_plan(b, nq, m, c))


def _launch(query: torch.Tensor, cand: torch.Tensor, values: torch.Tensor,
            cutoff: float, bias: torch.Tensor, kind: str, plan: InterpPlan
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`interp_kernel`'s launch under ``plan`` (CUDA float32 tensors
    of its shapes); the plan sweep and the card tests force other plans
    here."""
    b, nq = query.shape[:2]
    m, c = cand.shape[1], values.shape[-1]
    if not plan.admits(nq, m, c) and b * nq:
        raise ValueError(f"interp kernel: {plan} does not cover Nq={nq}, M={m}")
    query, cand = query.contiguous(), cand.contiguous()
    values, bias = values.contiguous(), bias.contiguous()
    out = torch.empty((b, nq, c), dtype=torch.float32, device=query.device)
    den = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    if b * nq == 0:
        return out, den
    partial = torch.empty((plan.splits, b * nq, c + 1), dtype=torch.float32,
                          device=query.device)
    inv_c2, k1, k2 = kernel_constants(cutoff, kind)
    KERNEL.launch("interp_f32", ptr(query), ptr(cand), ptr(values), ptr(bias),
                  ptr(partial), ptr(out), ptr(den), b, nq, m, c, plan.threads,
                  plan.splits, plan.span,
                  ctypes.c_float(d2_threshold(cutoff)), ctypes.c_float(inv_c2),
                  ctypes.c_float(k1), ctypes.c_float(k2), KINDS[kind],
                  stream_of(query))
    return out, den
