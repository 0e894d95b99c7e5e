"""Farthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain
PyTorch version.

Replaces ``tpugan_tpu/ops/pallas/fps_kernel.py : fps_pallas`` and
``fps_pallas_batched``. The kernel's source note says what bounds it on the
card and how it is laid out.
"""

from __future__ import annotations

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("fps", {"fps_f32": [VOIDP] * 4 + [INT] * 3 + [VOIDP]})

MAX_POINTS = 14336   # a row's points must fit the block's shared memory


def point_sqdist(pos: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x [B, 1, 3] -> [B, N]: ((dx*dx + dy*dy) + dz*dz), the
    kernel's order of operations."""
    d = pos - sel
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def fps_plain(pos: torch.Tensor, m: int, penalty: torch.Tensor,
              start: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: m sequential rounds of
    (distance update, argmax); ``argmax`` returns the first maximum."""
    b = pos.shape[0]
    rows = torch.arange(b, device=pos.device)
    idx = torch.empty((b, m), dtype=torch.int64, device=pos.device)
    cur = start.to(torch.int64)
    idx[:, 0] = cur
    mind = point_sqdist(pos, pos[rows, cur][:, None]) + penalty
    for i in range(1, m):
        cur = torch.argmax(mind, dim=1)
        idx[:, i] = cur
        mind = torch.minimum(mind,
                             point_sqdist(pos, pos[rows, cur][:, None]) + penalty)
    return idx


def fps_kernel(pos: torch.Tensor, m: int, penalty: torch.Tensor,
               start: torch.Tensor) -> torch.Tensor:
    """FPS indices [B, m] int64: round 0 is ``start``, round i the point
    farthest from rounds < i (lowest index on a tie).

    pos [B, N, 3] f32, penalty [B, N] f32 (0 valid, -1e10 invalid: never
    picked while a valid point remains), start [B] int. A CPU tensor takes
    :func:`fps_plain`; a CUDA tensor launches the kernel or raises.
    """
    b, n, d = pos.shape
    if d != 3 or penalty.shape != (b, n) or start.shape != (b,):
        raise ValueError(f"fps: shapes {tuple(pos.shape)}, "
                         f"{tuple(penalty.shape)}, {tuple(start.shape)}")
    if m < 1 or n < 1:
        raise ValueError(f"fps: m={m}, N={n}")
    if pos.device.type == "cpu":
        return fps_plain(pos, m, penalty, start)
    if not pos.is_cuda or penalty.device != pos.device or start.device != pos.device:
        raise ValueError(f"fps: tensors on {pos.device}, {penalty.device}, "
                         f"{start.device}")
    if {pos.dtype, penalty.dtype} != {torch.float32}:
        raise TypeError("fps kernel takes float32 pos and penalty")
    if n > MAX_POINTS:
        raise ValueError(f"fps kernel takes N <= {MAX_POINTS}; got {n}")
    pos, penalty = pos.contiguous(), penalty.contiguous()
    start = start.to(torch.int64).contiguous()
    idx = torch.empty((b, m), dtype=torch.int64, device=pos.device)
    if b == 0:
        return idx
    KERNEL.launch("fps_f32", ptr(pos), ptr(penalty), ptr(start), ptr(idx),
                  b, n, m, stream_of(pos))
    return idx
