"""Dense SPH-kernel interpolation: the CUDA kernel ``csrc/interp.cu`` and its
plain PyTorch version.

Replaces ``tpugan_tpu/ops/pallas/interp_kernel.py : kernel_interp_pallas``
(and ``chunked_dense_interp``'s candidate chunks, which the card does not
need). The kernel's source note says what bounds it on the card and how it
is laid out.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("interp", {
    "interp_f32": [VOIDP] * 6 + [INT] * 4 + [ctypes.c_float] * 3
    + [INT, VOIDP]})

KINDS = {"bicubic": 0, "spline1": 1, "linear": 2, "exponential": 3}
MAX_C = 8
_PLAIN_CHUNK = 1024   # query rows per [rows, M] block in the plain version


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


def interp_plain(query: torch.Tensor, cand: torch.Tensor, values: torch.Tensor,
                 cutoff: float, bias: torch.Tensor, kind: str = "bicubic"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (query chunks of [rows, M])."""
    outs, dens = [], []
    for s in range(0, query.shape[1], _PLAIN_CHUNK):
        diff = query[:, s:s + _PLAIN_CHUNK, None, :] - cand[:, None, :, :]
        d2 = (diff * diff).sum(-1) + bias[:, None, :]
        w = sph_weight(d2, cutoff, kind)
        den = w.sum(-1) + 1e-6
        outs.append(torch.matmul(w, values) / den[..., None])
        dens.append(den)
    return torch.cat(outs, 1), torch.cat(dens, 1)


def interp_kernel(query: torch.Tensor, cand: torch.Tensor,
                  values: torch.Tensor, cutoff: float, bias: torch.Tensor,
                  kind: str = "bicubic") -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Nq, C], den [B, Nq]): out = sum_c w values / den,
    den = sum_c w + 1e-6, over every candidate.

    query [B, Nq, 3], cand [B, M, 3], values [B, M, C], bias [B, M] (0
    valid, 1e10 invalid), all f32. A CPU tensor takes :func:`interp_plain`;
    a CUDA tensor launches the kernel or raises.
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
    query, cand = query.contiguous(), cand.contiguous()
    values, bias = values.contiguous(), bias.contiguous()
    out = torch.empty((b, nq, c), dtype=torch.float32, device=query.device)
    den = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    if b * nq == 0:
        return out, den
    inv_c2, k1, k2 = kernel_constants(cutoff, kind)
    KERNEL.launch("interp_f32", ptr(query), ptr(cand), ptr(values), ptr(bias),
                  ptr(out), ptr(den), b, nq, m, c, ctypes.c_float(inv_c2),
                  ctypes.c_float(k1), ctypes.c_float(k2), KINDS[kind],
                  stream_of(query))
    return out, den
