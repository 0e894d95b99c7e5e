"""Exact kNN: the CUDA kernel ``csrc/knn.cu`` and its plain PyTorch version.

Replaces ``tpugan_tpu/ops/pallas/knn_kernel.py : knn_pallas``. The kernel's
source note says what bounds it on the card and how it is laid out.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("knn", {"knn_f32": [VOIDP] * 5 + [INT] * 5 + [VOIDP]})

MAX_D = 64      # widest point / feature vector the kernel is compiled for
MAX_K = 32      # largest k bucket the kernel is compiled for at any D
MAX_K_POINTS = 64   # the k = 64 bucket, built for D <= 4 (points) only
_PLAIN_CHUNK = 2048   # query rows per [rows, Nc] block in the plain version


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
