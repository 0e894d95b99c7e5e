"""Farthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain
PyTorch version.

Replaces ``tpugan_tpu/ops/pallas/fps_kernel.py : fps_pallas`` and
``fps_pallas_batched``. The kernel's source note says what bounds it on the
card and how it is laid out; :func:`fps_plan` picks its variant and shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("fps", {"fps_f32": [VOIDP] * 4 + [INT] * 7 + [VOIDP]})

MAX_POINTS = 14336   # the rows the kernel takes (no caller needs more)

# The shapes fps.cu admits (its entry point refuses others):
WARP_PPT_MAX = 32           # fps_warp: up to 32 points a lane
CLUSTER_PPT_MAX = 16        # fps_cluster: up to 16 points a thread,
CLUSTER_THREADS_MAX = 256   # up to 256 threads a block,
CLUSTER_MAX = 16            # up to 16 blocks a row (8 portable)

# The plan's choices, from tools/fps_plan_sweep_torch.py on an H100 SXM
# (PERF.md): rows up to WARP_POINTS on one warp (at 512 points 0.28 us a round,
# one block of 4 warps 0.32); longer rows on the fewest blocks (a power of
# 2, up to PLAN_CLUSTER_MAX) that hold at most CTA_POINTS each, about
# PPT_TARGET points a thread (at 1,024 points one block of 128 threads,
# 0.34 us, beat one warp, 0.36; at 9,216 a cluster of 8 such blocks, 0.46,
# beat every other shape but, with 12 rows, 96-thread blocks by 5%).
WARP_POINTS = 512
CTA_POINTS = 1152
PPT_TARGET = 9
PLAN_CLUSTER_MAX = 8


@dataclass(frozen=True)
class FpsPlan:
    """A launch of ``fps.cu``: ``variant`` "warp" (one warp a row) or
    "cluster" (``cluster`` blocks a row), ``threads`` a block, ``ppt``
    points a thread. Block c of a row owns points [c * slice, (c + 1) *
    slice), thread t of it points c * slice + t * ppt + k, k < ppt."""
    variant: str
    cluster: int
    threads: int
    ppt: int

    @property
    def slice(self) -> int:
        return self.threads * self.ppt

    def admits(self, n: int) -> bool:
        """Whether ``fps.cu`` takes this shape for rows of ``n`` points."""
        if self.variant == "warp":
            shape_ok = (self.cluster == 1 and self.threads == 32
                        and 1 <= self.ppt <= WARP_PPT_MAX)
        else:
            shape_ok = (self.variant == "cluster"
                        and 1 <= self.cluster <= CLUSTER_MAX
                        and self.threads % 32 == 0
                        and 32 <= self.threads <= CLUSTER_THREADS_MAX
                        and 1 <= self.ppt <= CLUSTER_PPT_MAX)
        return shape_ok and 1 <= n <= self.cluster * self.slice


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def fps_plan(n: int) -> FpsPlan:
    """The kernel's launch for rows of ``n`` points (the same for any number
    of rows and of rounds)."""
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"fps kernel takes N <= {MAX_POINTS}; got {n}")
    if n <= WARP_POINTS:
        return FpsPlan("warp", 1, 32, _ceil(n, 32))
    c = 1
    while c < PLAN_CLUSTER_MAX and _ceil(n, c) > CTA_POINTS:
        c *= 2
    per_block = _ceil(n, c)
    threads = 32 * _ceil(per_block, 32 * PPT_TARGET)
    return FpsPlan("cluster", c, threads, _ceil(per_block, threads))


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
               start: torch.Tensor, plan: FpsPlan | None = None
               ) -> torch.Tensor:
    """FPS indices [B, m] int64: round 0 is ``start``, round i the point
    farthest from rounds < i (lowest index on a tie).

    pos [B, N, 3] f32, penalty [B, N] f32 (0 valid, -1e10 invalid: never
    picked while a valid point remains), start [B] int. A CPU tensor takes
    :func:`fps_plain`; a CUDA tensor launches the kernel or raises.
    ``plan``: the launch (default :func:`fps_plan`), named by measurements
    of other shapes.
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
    plan = plan or fps_plan(n)
    if not plan.admits(n):
        raise ValueError(f"fps kernel: {plan} does not cover N={n}")
    idx = torch.empty((b, m), dtype=torch.int64, device=pos.device)
    if b == 0:
        return idx
    KERNEL.launch("fps_f32", ptr(pos), ptr(penalty), ptr(start), ptr(idx),
                  b, n, m, int(plan.variant == "cluster"), plan.cluster,
                  plan.threads, plan.ppt, stream_of(pos))
    return idx
