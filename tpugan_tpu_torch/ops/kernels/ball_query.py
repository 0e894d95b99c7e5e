"""Ball query in candidate-index order: the CUDA kernel
``csrc/ball_query.cu`` and its plain PyTorch version.

Replaces ``tpugan_tpu/ops/pallas/ball_query_kernel.py : ball_query_pallas``.
The kernel's source note says what bounds it on the card and how it is laid
out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("ball_query", {
    "ball_query_f32": [VOIDP] * 4 + [INT] * 4 + [ctypes.c_float, VOIDP]})

_PLAIN_CHUNK = 1024   # query rows per [rows, Nc] block in the plain version


def radius_sq(radius: float) -> float:
    """radius^2 rounded as the JAX package rounds it (``float32(r) ** 2``)."""
    return float(np.float32(radius) ** 2)


def ball_sqdist(query: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[B, Nq, 3] x [B, Nc, 3] -> [B, Nq, Nc]: ``(|q|^2 + |c|^2) - 2 q.c``
    with each sum taken as (x + y) + z, the kernel's order of operations."""
    def dot(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]

    q, c = query[:, :, None, :], cand[:, None, :, :]
    return (dot(q, q) + dot(c, c)) - 2.0 * dot(q, c)


def ball_query_plain(query: torch.Tensor, cand: torch.Tensor, radius: float,
                     nsample: int, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the ``nsample`` smallest
    in-ball candidate indices, by a sort of (index if in ball else Nc)."""
    nc = cand.shape[1]
    r2 = radius_sq(radius)
    iota = torch.arange(nc, device=cand.device)
    outs = []
    for s in range(0, query.shape[1], _PLAIN_CHUNK):
        d2 = ball_sqdist(query[:, s:s + _PLAIN_CHUNK], cand)
        within = (d2 < r2) & (bias < 1.0)[:, None, :]
        key = torch.where(within, iota, nc)
        key = torch.sort(key, dim=-1).values[..., :nsample]
        if nsample > nc:
            key = torch.cat([key, key.new_full(key.shape[:-1] + (nsample - nc,),
                                               nc)], -1)
        found = key < nc
        first = torch.where(found[..., :1], key[..., :1], 0)
        outs.append(torch.where(found, key, first))
    return torch.cat(outs, 1)


def ball_query_kernel(query: torch.Tensor, cand: torch.Tensor, radius: float,
                      nsample: int, bias: torch.Tensor) -> torch.Tensor:
    """idx [B, Nq, nsample] int64: the first ``nsample`` candidates in index
    order with d2 < radius^2 and bias < 1; missing slots repeat the first
    hit (0 when the ball is empty).

    query [B, Nq, 3] f32, cand [B, Nc, 3] f32, bias [B, Nc] f32 (0 valid,
    >= 1 invalid). A CPU tensor takes :func:`ball_query_plain`; a CUDA
    tensor launches the kernel or raises.
    """
    b, nq, d = query.shape
    nc = cand.shape[1]
    if d != 3 or cand.shape != (b, nc, 3) or bias.shape != (b, nc):
        raise ValueError(f"ball_query: shapes {tuple(query.shape)}, "
                         f"{tuple(cand.shape)}, {tuple(bias.shape)}")
    if nsample < 1 or nc < 1:
        raise ValueError(f"ball_query: nsample={nsample}, Nc={nc}")
    if query.device.type == "cpu":
        return ball_query_plain(query, cand, radius, nsample, bias)
    if not query.is_cuda or cand.device != query.device or bias.device != query.device:
        raise ValueError(f"ball_query: tensors on {query.device}, "
                         f"{cand.device}, {bias.device}")
    if {query.dtype, cand.dtype, bias.dtype} != {torch.float32}:
        raise TypeError("ball_query kernel takes float32 query, cand and bias")
    query, cand, bias = query.contiguous(), cand.contiguous(), bias.contiguous()
    idx = torch.empty((b, nq, nsample), dtype=torch.int64, device=query.device)
    if b * nq == 0:
        return idx
    KERNEL.launch("ball_query_f32", ptr(query), ptr(cand), ptr(bias), ptr(idx),
                  b, nq, nc, nsample, ctypes.c_float(radius_sq(radius)),
                  stream_of(query))
    return idx
