"""Fused EdgeConv forward: the CUDA kernel ``csrc/edgeconv.cu`` and its plain
PyTorch version.

Replaces ``tpugan_tpu/ops/pallas/edgeconv_kernel.py : edgeconv_fused`` (its
forward). The kernel's source note says what bounds it on the card and how
it is laid out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("edgeconv",
                    {"edgeconv_fwd": [VOIDP] * 7 + [INT] * 9 + [VOIDP]})

AGGREGATES = {"max": 0, "min": 1, "sum": 2, "mean": 3}
MAX_WIDTH = 256   # widest hidden / output layer (one thread per column)


def _round(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """f32 tensor holding ``x`` rounded to the compute dtype."""
    return x.to(cdt).float()


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def edgeconv_plain(nbr_t, ctr, wn, we, w1=None, w2=None, aggregate="max",
                   compute_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: products of values rounded to
    the compute dtype, accumulated in f32; each layer rounded to the compute
    dtype; the aggregate folded plane by plane in the compute dtype."""
    cdt = compute_dtype
    nb = _round(nbr_t, cdt)                                  # [B, K, N, C]
    edge = _round(nb - _round(ctr, cdt)[:, None], cdt)
    y = _round(_lrelu(nb @ _round(wn, cdt)) + _lrelu(edge @ _round(we, cdt)),
               cdt)
    if w1 is not None:
        y = _round(_lrelu(y @ _round(w1, cdt)), cdt)
        y = _round(_lrelu(y @ _round(w2, cdt)), cdt)
    acc = y[:, 0]
    for j in range(1, y.shape[1]):
        if aggregate == "max":
            acc = torch.maximum(acc, y[:, j])
        elif aggregate == "min":
            acc = torch.minimum(acc, y[:, j])
        else:
            acc = _round(acc + y[:, j], cdt)
    if aggregate == "mean":
        acc = _round(acc / y.shape[1], cdt)
    return acc.to(cdt)


def edgeconv_fused(nbr_t: torch.Tensor, ctr: torch.Tensor, wn: torch.Tensor,
                   we: torch.Tensor, w1: Optional[torch.Tensor] = None,
                   w2: Optional[torch.Tensor] = None, aggregate: str = "max",
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused EdgeConv tail on a neighbour-major table -> [B, N, O].

    nbr_t [B, K, N, C], ctr [B, N, C], wn / we [C, H], w1 [H, H] and
    w2 [H, O] (both None: no SharedMLP, O = H); bias-free, norm-free,
    leaky-ReLU slope 0.2; compute dtype float32 or bfloat16. A CPU tensor
    takes :func:`edgeconv_plain`; a CUDA tensor launches the kernel or
    raises.
    """
    b, k, n, c = nbr_t.shape
    h = wn.shape[1]
    mlp = w1 is not None
    o = w2.shape[1] if mlp else h
    if (ctr.shape != (b, n, c) or wn.shape != (c, h) or we.shape != (c, h)
            or (mlp and (w1.shape != (h, h) or w2.shape[0] != h))
            or (w2 is not None) != mlp):
        raise ValueError("edgeconv: inconsistent shapes")
    if aggregate not in AGGREGATES:
        raise ValueError(f"edgeconv: aggregate {aggregate!r}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"edgeconv: compute dtype {compute_dtype}")
    if k < 1:
        raise ValueError("edgeconv: no neighbour planes")
    if nbr_t.device.type == "cpu":
        return edgeconv_plain(nbr_t, ctr, wn, we, w1, w2, aggregate,
                              compute_dtype)
    if not nbr_t.is_cuda or any(
            t.device != nbr_t.device for t in (ctr, wn, we, w1, w2)
            if t is not None):
        raise ValueError("edgeconv: tensors on more than one device")
    if max(h, o) > MAX_WIDTH:
        raise ValueError(f"edgeconv kernel takes H, O <= {MAX_WIDTH}; "
                         f"got H={h}, O={o}")
    args = [t.to(compute_dtype).contiguous() if t is not None else None
            for t in (nbr_t, ctr, wn, we, w1, w2)]
    out = torch.empty((b, n, o), dtype=compute_dtype, device=nbr_t.device)
    if b * n == 0:
        return out
    ptrs = [ptr(t) if t is not None else VOIDP(0) for t in args]
    KERNEL.launch("edgeconv_fwd", *ptrs, ptr(out), b, k, n, c, h, o,
                  int(mlp), AGGREGATES[aggregate],
                  int(compute_dtype == torch.bfloat16), stream_of(out))
    return out
