"""Fused EdgeConv forward and backward: the CUDA kernels ``csrc/edgeconv.cu``
and their plain PyTorch versions.

Replaces ``tpugan_tpu/ops/pallas/edgeconv_kernel.py : edgeconv_fused``, its
forward (``_fwd_pallas``) and its backward (``_bwd_pallas``).
:func:`edgeconv_fused` is differentiable: its autograd Function saves
``(nbr_t, ctr, wn, we, w1, w2)``, as the JAX VJP does, and its backward is
the backward kernel (or, on the CPU, :func:`edgeconv_backward_plain`).
``KERNEL`` counts forward launches, ``BWD`` backward launches (one per
call: the kernel and the pass that adds the blocks' weight-gradient
partials); both handles load the same library. A bf16 forward at a class
of ``TC_CLASSES`` launches the tensor-core kernel
(``edgeconv_fwd_bf16_tc``) through ``KERNEL``, and ``TC_LAUNCHES`` counts
those launches alone. An f32 forward at a class of ``F32_TILED_CLASSES``
launches the register-tiled f32 kernel (``edgeconv_fwd_f32_tiled``)
through ``KERNEL``, and ``F32_TILED_LAUNCHES`` counts those launches
alone. Every other forward launches ``edgeconv_fwd``. An f32 backward at
a class of ``F32_TILED_BWD_CLASSES`` (every f32 class of the fused train
step) launches the redesigned backward (``edgeconv_bwd_f32_tiled``:
layer-wise products on GEMM tiles, or at the IDGCN's class one plane-row
a thread; its launches, scratch and partials from :func:`tiled_bwd_plan`)
through ``BWD``, and ``F32_TILED_BWD_LAUNCHES`` counts those launches
alone; every other backward launches ``edgeconv_bwd``. The kernels'
source note says what bounds them on the card and how they are laid out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpugan_tpu_torch._build import INT, VOIDP, CudaKernel, ptr, stream_of

KERNEL = CudaKernel("edgeconv",
                    {"edgeconv_fwd": [VOIDP] * 7 + [INT] * 9 + [VOIDP],
                     "edgeconv_fwd_bf16_tc": [VOIDP] * 7 + [INT] * 8 + [VOIDP],
                     "edgeconv_fwd_f32_tiled": [VOIDP] * 7 + [INT] * 8 + [VOIDP]})
BWD = CudaKernel("edgeconv",
                 {"edgeconv_bwd": [VOIDP] * 11 + [INT] * 10 + [VOIDP],
                  "edgeconv_bwd_f32_tiled": [VOIDP] * 12 + [INT] * 13 + [VOIDP]})

AGGREGATES = {"max": 0, "min": 1, "sum": 2, "mean": 3}
MAX_WIDTH = 256   # widest hidden / output layer (one thread per column)
MAX_BLOCKS = 264  # blocks of the backward (2 per SM): bounds its scratch
TILE = 16         # points per block tile (csrc/edgeconv.cu : TP)
# (mlp, C, H, O) of the bf16 tensor-core kernel
TC_CLASSES = frozenset({(True, 64, 128, 256), (False, 64, 128, 128),
                        (True, 6, 64, 128), (True, 32, 16, 32)})
TC_LAUNCHES = 0              # launches of the tensor-core kernel
# (mlp, C, H, O) of the f32 register-tiled kernel: the fluid generator's
# four classes and the action generator's EdgeConv_0 (C = 3)
ACTION_EC0_CLASS = (True, 3, 64, 128)
F32_TILED_CLASSES = frozenset({(True, 64, 128, 256), (False, 64, 128, 128),
                               (True, 6, 64, 128), (True, 32, 16, 32),
                               ACTION_EC0_CLASS})
F32_TILED_LAUNCHES = 0       # launches of the f32 register-tiled kernel
# (mlp, C, H, O) of the redesigned f32 backward (csrc/edgeconv.cu): the
# upsampler's and mask head's, the mask head's sum, EdgeConv_0's and the
# action generator's EdgeConv_0 on GEMM tiles (bwdt), the IDGCN's one
# plane-row a thread (rowf, ROWF_CLASS)
DEFAULT_TILED_BWD_CLASS = (True, 64, 128, 256)
ROWF_CLASS = (True, 32, 16, 32)
F32_TILED_BWD_CLASSES = frozenset({DEFAULT_TILED_BWD_CLASS,
                                   (False, 64, 128, 128), (True, 6, 64, 128),
                                   ROWF_CLASS, ACTION_EC0_CLASS})
F32_TILED_BWD_LAUNCHES = 0   # launches of the redesigned f32 backward
# Its row products take tiles of BWD_ROW_TILE plane-rows; each dW product
# splits the rows into ranges of a multiple of DW_BK rows, so that about
# DW_BLOCKS blocks run, each over at least DW_MIN_ROWS rows; each row keeps
# sign_words(mlp, h) words of slopes (z1a, z1b, z2) beside h1, h2, z3 and
# its edge (SIGN_WORDS at the default class). At a narrow C (C % 4 != 0:
# the two EdgeConv_0s, C = 6 and 3) gnbr, dWn and dWe take a tail kernel
# over NARROW_TILE-row tiles on at most NARROW_BLOCKS blocks, each keeping
# 2 C H partial sums. The IDGCN's kernel walks tiles of ROWF_TILE
# plane-rows on at most ROWF_BLOCKS blocks, each block keeping ROWF_PART
# partial dW sums (dWn, dWe, dW1, dW2).
BWD_ROW_TILE, DW_BLOCKS, DW_MIN_ROWS, DW_BK, SIGN_WORDS = 128, 264, 64, 8, 12
NARROW_TILE, NARROW_BLOCKS = 64, 528
ROWF_TILE, ROWF_BLOCKS, ROWF_PART = 128, 264, 2 * 32 * 16 + 16 * 16 + 16 * 32


def _round(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """f32 tensor holding ``x`` rounded to the compute dtype."""
    return x.to(cdt).float()


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _lrelu_grad(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, 1.0, 0.2)


def _layers(nbr_t, ctr, wn, we, w1, w2, cdt):
    """Every plane's activations in the kernels' arithmetic: (nb, edge, z1a,
    z1b, h1, z2, h2, z3, y), [B, K, N, .] f32 holding compute-dtype values
    where the kernels round (z2, h2, z3 None without the MLP)."""
    nb = _round(nbr_t, cdt)                                  # [B, K, N, C]
    edge = _round(nb - _round(ctr, cdt)[:, None], cdt)
    z1a, z1b = nb @ _round(wn, cdt), edge @ _round(we, cdt)
    h1 = _round(_lrelu(z1a) + _lrelu(z1b), cdt)
    if w1 is None:
        return nb, edge, z1a, z1b, h1, None, None, None, h1
    z2 = h1 @ _round(w1, cdt)
    h2 = _round(_lrelu(z2), cdt)
    z3 = h2 @ _round(w2, cdt)
    return nb, edge, z1a, z1b, h1, z2, h2, z3, _round(_lrelu(z3), cdt)


def edgeconv_plain(nbr_t, ctr, wn, we, w1=None, w2=None, aggregate="max",
                   compute_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: products of values rounded to
    the compute dtype, accumulated in f32; each layer rounded to the compute
    dtype; the aggregate folded plane by plane in the compute dtype."""
    cdt = compute_dtype
    y = _layers(nbr_t, ctr, wn, we, w1, w2, cdt)[-1]
    acc = y[:, 0]
    for j in range(1, y.shape[1]):
        if aggregate == "max":
            acc = torch.maximum(acc, y[:, j])
        elif aggregate == "min":
            acc = torch.minimum(acc, y[:, j])
        else:
            acc = _round(acc + y[:, j], cdt)
    if aggregate == "mean":
        # true division on every device, as the kernels and jnp divide (on
        # a CUDA tensor, a division by a Python number multiplies by its
        # rounded reciprocal instead)
        acc = _round(acc / torch.full_like(acc, y.shape[1]), cdt)
    return acc.to(cdt)


def edgeconv_backward_plain(nbr_t, ctr, wn, we, w1, w2, g, aggregate="max",
                            compute_dtype=torch.float32):
    """(gnbr, gctr, gwn, gwe, gw1, gw2) by the backward kernel's formulas
    (``csrc/edgeconv.cu``, above ``edgeconv_bwd_kernel``): the cotangent of
    each plane's output (max / min: split over the planes equal to the
    aggregate, recomputed here), then each layer's backward with every
    cotangent rounded to the compute dtype before it enters a product.
    gnbr and gctr come in the dtypes of ``nbr_t`` and ``ctr``, the weight
    gradients in the weights' dtypes (accumulated in f32)."""
    cdt = compute_dtype
    k = nbr_t.shape[1]
    nb, edge, z1a, z1b, h1, z2, h2, z3, y = _layers(nbr_t, ctr, wn, we, w1,
                                                    w2, cdt)
    g = _round(g, cdt)[:, None]                              # [B, 1, N, O]
    if aggregate in ("max", "min"):
        acc = y.amax(1, keepdim=True) if aggregate == "max" else y.amin(
            1, keepdim=True)
        tie = (y == acc).float()
        gy = g * tie / tie.sum(1, keepdim=True)
    elif aggregate == "sum":
        gy = g.expand_as(y)
    else:
        gy = (g / k).expand_as(y)
    rows = lambda a, b: torch.einsum("bknc,bknh->ch", a, b)
    gw1 = gw2 = None
    if w1 is not None:
        d3 = _round(gy * _lrelu_grad(z3), cdt)
        gw2 = rows(h2, d3).to(w2.dtype)
        d2 = _round((d3 @ _round(w2, cdt).t()) * _lrelu_grad(z2), cdt)
        gw1 = rows(h1, d2).to(w1.dtype)
        gh1 = d2 @ _round(w1, cdt).t()
    else:
        gh1 = gy
    d1a = _round(gh1 * _lrelu_grad(z1a), cdt)
    d1b = _round(gh1 * _lrelu_grad(z1b), cdt)
    gnb_b = d1b @ _round(we, cdt).t()
    gnbr = (d1a @ _round(wn, cdt).t() + gnb_b).to(nbr_t.dtype)
    gctr = (-gnb_b.sum(1)).to(ctr.dtype)
    return (gnbr, gctr, rows(nb, d1a).to(wn.dtype), rows(edge, d1b).to(we.dtype),
            gw1, gw2)


# ------------------------------------------------------------ kernel launches

def _check(nbr_t, ctr, wn, we, w1, w2, aggregate, compute_dtype):
    """(b, k, n, c, h, o, mlp) of valid arguments; raises on the rest."""
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
    return b, k, n, c, h, o, mlp


def _check_card(tensors, h, o):
    first = tensors[0]
    if not first.is_cuda or any(t.device != first.device for t in tensors
                                if t is not None):
        raise ValueError("edgeconv: tensors on more than one device")
    if max(h, o) > MAX_WIDTH:
        raise ValueError(f"edgeconv kernel takes H, O <= {MAX_WIDTH}; "
                         f"got H={h}, O={o}")


def _operands(tensors, cdt):
    return [t.to(cdt).contiguous() if t is not None else None for t in tensors]


def _ptrs(tensors):
    return [ptr(t) if t is not None else VOIDP(0) for t in tensors]


def takes_tensor_cores(cdt, mlp, c, h, o) -> bool:
    """Whether a forward on the card launches the tensor-core kernel: the
    bf16 forward at a class of ``TC_CLASSES``."""
    return cdt is torch.bfloat16 and (bool(mlp), c, h, o) in TC_CLASSES


def takes_f32_tiled(cdt, mlp, c, h, o) -> bool:
    """Whether a forward on the card launches the f32 register-tiled
    kernel: the f32 forward at a class of ``F32_TILED_CLASSES``."""
    return cdt is torch.float32 and (bool(mlp), c, h, o) in F32_TILED_CLASSES


def takes_f32_tiled_bwd(cdt, mlp, c, h, o) -> bool:
    """Whether a backward on the card launches the redesigned f32 backward:
    the f32 backward at a class of ``F32_TILED_BWD_CLASSES``, for every
    aggregate."""
    return cdt is torch.float32 and (bool(mlp), c, h, o) in F32_TILED_BWD_CLASSES


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_ranges(rows: int, split_rows: int):
    """The row ranges [r0, r1) of a dW product's partials, in block
    order (``dw_gemm`` in ``csrc/gemm_tile.cuh``: split s takes rows s
    split_rows up to the next split's first or ``rows``)."""
    return [(r0, min(rows, r0 + split_rows)) for r0 in range(0, rows, split_rows)]


def sign_words(mlp: bool, h: int) -> int:
    """Sign words a plane-row keeps (csrc/edgeconv.cu : bwdt::Shape::SW):
    h / 32 for each of z1a, z1b and, with the SharedMLP, z2."""
    return (3 if mlp else 2) * (h // 32)


def _dw_tile(m: int) -> int:
    """A dW product's tile along an extent of m (bwdt::dw_tile)."""
    return 128 if m >= 128 else 64


def tiled_bwd_plan(b: int, k: int, n: int,
                   cls: tuple = DEFAULT_TILED_BWD_CLASS) -> dict:
    """The redesigned f32 backward for nbr_t [b, k, n, C] at the class cls
    = (mlp, C, H, O) of ``F32_TILED_BWD_CLASSES`` (by default the
    upsampler's (64, 128, 256)): ``rows`` (R = b k n plane-rows),
    ``design`` and ``part_floats`` (the partial dW sums), ``scratch_floats``.

    ``"gemm"`` (layer-wise products on GEMM tiles): ``row_tiles`` (the row
    products' tiles), per dW product on GEMM tiles in launch order (dW2,
    dW1 with the SharedMLP, then dWn, dWe) its name in ``products``, its
    (M, N) in ``dw``, ``split_rows`` and ``splits``; at a narrow C
    (``narrow``: C % 4 != 0) dWn and dWe are not among them but in the
    tail kernel's ``blocks`` partials of 2 C H over ``narrow_tiles`` tiles
    (else ``blocks`` 0); scratch h1 (and with the SharedMLP h2), z3 or d1b
    and the cotangents over them, R (2 H + O) or R 2 H, the edges nb - ctr,
    R C rounded up to a multiple of H / 32 (the sign words move H / 32 at a
    time), then R sign_words(mlp, H) words of slopes; part_floats the
    largest partials. ``"rows"`` (the IDGCN, one plane-row a thread):
    ``row_tiles`` (ROWF_TILE rows each), ``blocks`` (at most ROWF_BLOCKS,
    each walking tiles blockIdx, + blocks, ...); scratch z3, then d3, then
    d1b We^T, R O; part_floats blocks ROWF_PART.
    Raises ValueError past the kernels' 32-bit indexing or outside the
    classes."""
    mlp, c, h, o = cls
    if (bool(mlp), c, h, o) not in F32_TILED_BWD_CLASSES:
        raise ValueError(f"edgeconv tiled backward: no class {cls}")
    rows = b * k * n
    wide = max(h, o)
    if rows * wide >= 2 ** 31:
        raise ValueError(f"edgeconv tiled backward takes fewer than 2^31 / "
                         f"{wide} plane-rows, got {rows}")
    if (bool(mlp), c, h, o) == ROWF_CLASS:
        tiles = _cdiv(rows, ROWF_TILE)
        blocks = max(1, min(ROWF_BLOCKS, tiles))
        return dict(rows=rows, design="rows", row_tiles=tiles, blocks=blocks,
                    scratch_floats=rows * o, part_floats=blocks * ROWF_PART)
    narrow = c % 4 != 0
    products = (["dW2", "dW1"] if mlp else []) + ([] if narrow else ["dWn", "dWe"])
    dws = ([(h, o), (h, h)] if mlp else []) + ([] if narrow else [(c, h), (c, h)])
    split_rows, splits, part = [], [], 0
    narrow_tiles = _cdiv(rows, NARROW_TILE)
    blocks = max(1, min(NARROW_BLOCKS, narrow_tiles)) if narrow else 0
    if narrow:
        part = blocks * 2 * c * h
    for m, nn in dws:
        tiles = _cdiv(m, _dw_tile(m)) * _cdiv(nn, _dw_tile(nn))
        s = max(1, min(_cdiv(rows, DW_MIN_ROWS), _cdiv(DW_BLOCKS, tiles)))
        sr = max(DW_BK, _cdiv(_cdiv(rows, s), DW_BK) * DW_BK)
        split_rows.append(sr)
        splits.append(_cdiv(rows, sr))
        part = max(part, splits[-1] * m * nn)
    extra = dict(narrow_tiles=narrow_tiles) if narrow else {}
    return dict(rows=rows, design="gemm", narrow=narrow,
                row_tiles=_cdiv(rows, BWD_ROW_TILE), products=products, dw=dws,
                split_rows=tuple(split_rows), splits=tuple(splits),
                blocks=blocks, **extra,
                scratch_floats=rows * ((2 * h + o if mlp else 2 * h)
                                       + sign_words(mlp, h))
                + _cdiv(rows * c, h // 32) * (h // 32),
                part_floats=part)


def _tiled_ints(plan: dict) -> tuple:
    """The entry point's split rows of dW2, dW1, dWn, dWe (0 where no GEMM
    tile computes it) and its blocks (the narrow tail's or the IDGCN
    kernel's; 0 without either)."""
    if plan["design"] == "rows":
        return (0, 0, 0, 0, plan["blocks"])
    split = dict(zip(plan["products"], plan["split_rows"]))
    return tuple(split.get(p, 0) for p in ("dW2", "dW1", "dWn", "dWe")) + (
        plan["blocks"],)


def _aligned(args):
    """The operands, each cloned where its view does not start on 16 bytes
    (the kernels move 16 bytes at a time; a view may start anywhere)."""
    return [a if a is None or a.data_ptr() % 16 == 0 else a.clone()
            for a in args]


def _forward(nbr_t, ctr, wn, we, w1, w2, aggregate, cdt):
    b, k, n, c, h, o, mlp = _check(nbr_t, ctr, wn, we, w1, w2, aggregate, cdt)
    if nbr_t.device.type == "cpu":
        return edgeconv_plain(nbr_t, ctr, wn, we, w1, w2, aggregate, cdt)
    _check_card([nbr_t, ctr, wn, we, w1, w2], h, o)
    args = _operands((nbr_t, ctr, wn, we, w1, w2), cdt)
    out = torch.empty((b, n, o), dtype=cdt, device=nbr_t.device)
    if b * n == 0:
        return out
    if takes_tensor_cores(cdt, mlp, c, h, o):
        global TC_LAUNCHES
        KERNEL.launch("edgeconv_fwd_bf16_tc", *_ptrs(_aligned(args)), ptr(out),
                      b, k, n, c, h, o, int(mlp), AGGREGATES[aggregate],
                      stream_of(out))
        TC_LAUNCHES += 1
        return out
    if takes_f32_tiled(cdt, mlp, c, h, o):
        global F32_TILED_LAUNCHES
        KERNEL.launch("edgeconv_fwd_f32_tiled", *_ptrs(_aligned(args)),
                      ptr(out), b, k, n, c, h, o, int(mlp),
                      AGGREGATES[aggregate], stream_of(out))
        F32_TILED_LAUNCHES += 1
        return out
    KERNEL.launch("edgeconv_fwd", *_ptrs(args), ptr(out), b, k, n, c, h, o,
                  int(mlp), AGGREGATES[aggregate], int(cdt == torch.bfloat16),
                  stream_of(out))
    return out


def edgeconv_backward(nbr_t, ctr, wn, we, w1, w2, g, aggregate="max",
                      compute_dtype=torch.float32):
    """Gradients (gnbr, gctr, gwn, gwe, gw1, gw2) of :func:`edgeconv_fused`
    for the cotangent ``g`` [B, N, O]. A CPU tensor takes
    :func:`edgeconv_backward_plain`; a CUDA tensor launches the backward
    kernel or raises."""
    cdt = compute_dtype
    b, k, n, c, h, o, mlp = _check(nbr_t, ctr, wn, we, w1, w2, aggregate, cdt)
    if g.shape != (b, n, o):
        raise ValueError(f"edgeconv: cotangent {tuple(g.shape)}, output "
                         f"{(b, n, o)}")
    if nbr_t.device.type == "cpu":
        return edgeconv_backward_plain(nbr_t, ctr, wn, we, w1, w2, g,
                                       aggregate, cdt)
    _check_card([nbr_t, ctr, wn, we, w1, w2, g], h, o)
    dev = nbr_t.device
    args = _operands((nbr_t, ctr, wn, we, w1, w2, g), cdt)
    gnbr = torch.empty((b, k, n, c), device=dev)
    gctr = torch.empty((b, n, c), device=dev)
    sizes = [c * h, c * h] + ([h * h, h * o] if mlp else [])
    dw = torch.empty(sum(sizes), device=dev)
    if b * n and takes_f32_tiled_bwd(cdt, mlp, c, h, o):
        global F32_TILED_BWD_LAUNCHES
        plan = tiled_bwd_plan(b, k, n, (mlp, c, h, o))
        scratch = torch.empty(plan["scratch_floats"], device=dev)
        part = torch.empty(plan["part_floats"], device=dev)
        BWD.launch("edgeconv_bwd_f32_tiled", *_ptrs(_aligned(args)), ptr(gnbr),
                   ptr(gctr), ptr(dw), ptr(scratch), ptr(part), b, k, n, c, h,
                   o, int(mlp), AGGREGATES[aggregate], *_tiled_ints(plan),
                   stream_of(gnbr))
        F32_TILED_BWD_LAUNCHES += 1
    elif b * n:
        nblk = min(b * -(-n // TILE), MAX_BLOCKS)
        dw_part = torch.zeros((nblk, dw.numel()), device=dev)
        BWD.launch("edgeconv_bwd", *_ptrs(args), ptr(gnbr), ptr(gctr),
                   ptr(dw_part), ptr(dw), b, k, n, c, h, o, int(mlp),
                   AGGREGATES[aggregate], int(cdt == torch.bfloat16), nblk,
                   stream_of(gnbr))
    else:
        dw.zero_()
    shapes = [(c, h), (c, h)] + ([(h, h), (h, o)] if mlp else [])
    parts = [p.view(s) for p, s in zip(torch.split(dw, sizes), shapes)]
    weights = [wn, we] + ([w1, w2] if mlp else [])
    grads = [p.to(w.dtype) for p, w in zip(parts, weights)]
    if not mlp:
        grads += [None, None]
    return (gnbr.to(nbr_t.dtype), gctr.to(ctr.dtype), *grads)


class _EdgeConvFused(torch.autograd.Function):
    """edgeconv_fused with its kernel backward; saves the forward's inputs
    and recomputes the rest (the JAX VJP's residuals)."""

    @staticmethod
    def forward(ctx, nbr_t, ctr, wn, we, w1, w2, aggregate, cdt):
        ctx.aggregate, ctx.cdt = aggregate, cdt
        ctx.save_for_backward(nbr_t, ctr, wn, we, w1, w2)
        return _forward(nbr_t, ctr, wn, we, w1, w2, aggregate, cdt)

    @staticmethod
    def backward(ctx, g):
        grads = edgeconv_backward(*ctx.saved_tensors, g.contiguous(),
                                  ctx.aggregate, ctx.cdt)
        return (*grads, None, None)


def edgeconv_fused(nbr_t: torch.Tensor, ctr: torch.Tensor, wn: torch.Tensor,
                   we: torch.Tensor, w1: Optional[torch.Tensor] = None,
                   w2: Optional[torch.Tensor] = None, aggregate: str = "max",
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused EdgeConv tail on a neighbour-major table -> [B, N, O].

    nbr_t [B, K, N, C], ctr [B, N, C], wn / we [C, H], w1 [H, H] and
    w2 [H, O] (both None: no SharedMLP, O = H); bias-free, norm-free,
    leaky-ReLU slope 0.2; compute dtype float32 or bfloat16. Differentiable
    in all six tensors; where autograd is off or no tensor requires a
    gradient (serving), the forward runs without the autograd Function, so
    nothing is saved for a backward. A CPU tensor takes the plain versions;
    a CUDA tensor launches the kernels or raises.
    """
    args = (nbr_t, ctr, wn, we, w1, w2)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return _EdgeConvFused.apply(*args, aggregate, compute_dtype)
    return _forward(*args, aggregate, compute_dtype)
