"""Streaming 1-NN: the CUDA kernel ``csrc/nn1.cu`` and its plain PyTorch
version.

Replaces ``tpugan_tpu/ops/pallas/nn1_kernel.py : nn1_pallas``. The kernel's
source note says what bounds it on the card and how it is laid out.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of
from tpugan_tpu_torch.ops.kernels.knn import sqdist

KERNEL = CudaKernel("nn1", {"nn1_f32": [VOIDP] * 5 + [INT] * 3 + [VOIDP]})

_PLAIN_CHUNK = 2048   # query rows per [rows, M] block in the plain version


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
    tensor launches the kernel or raises.
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
    query, cand, bias = query.contiguous(), cand.contiguous(), bias.contiguous()
    d2 = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq), dtype=torch.int64, device=query.device)
    if b * nq == 0:
        return d2, idx
    KERNEL.launch("nn1_f32", ptr(query), ptr(cand), ptr(bias), ptr(d2),
                  ptr(idx), b, nq, m, stream_of(query))
    return d2, idx
