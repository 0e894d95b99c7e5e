"""The f32 fused-EdgeConv backward on GEMM tiles at (C, H, O) = (64, 128,
256): its oracle against the JAX package, its dispatch and its launch plan.

* ``edgeconv_backward_plain`` (the card kernel's oracle) against the Pallas
  backward ``_bwd_pallas`` run in interpret mode at the class's widths, N =
  40 (a multiple of 8, so the Pallas body runs), k = 12 and 4 (the
  upsampler's and the mask head's), every aggregate, and a table whose
  duplicated planes tie exactly at the max.
* ``takes_f32_tiled_bwd``: only the f32 backward at a class of the fused
  train step takes the redesigned kernel, whatever the aggregate
  (``tests/test_torch_edgeconv_bwd_classes.py`` covers the other classes).
* ``tiled_bwd_plan``: the dW products' row ranges cover every row once, in
  order, at sizes off the 128-row tile; the partials and the scratch match
  their formulas.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan_tpu.ops.pallas.edgeconv_kernel import _bwd_pallas
from tpugan_tpu_torch.ops.kernels import edgeconv as E

C, H, O = 64, 128, 256


@pytest.mark.parametrize("k,agg,ties", [
    (12, "max", False), (12, "min", False), (12, "sum", False),
    (12, "mean", False), (4, "max", False), (4, "min", False),
    (4, "sum", False), (4, "mean", False), (12, "max", True)])
def test_plain_backward_matches_pallas_at_tiled_class(rng, k, agg, ties):
    """f32 to the 3e-5 of tests/test_torch_edgeconv_bwd.py (summation
    order); tied planes split every cotangent they share evenly."""
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    n = 40
    nbr, ctr = f(1, k, n, C), f(1, n, C)
    if ties:
        nbr[:, 1], nbr[:, 5] = nbr[:, 0], nbr[:, 3]
    ws = (f(C, H, sc=C ** -0.5), f(C, H, sc=C ** -0.5), f(H, H, sc=H ** -0.5),
          f(H, O, sc=H ** -0.5))
    g = f(1, n, O)
    want = _bwd_pallas(*(jnp.asarray(a) for a in (nbr, ctr, *ws, g)),
                       aggregate=agg, cdt=jnp.float32)
    assert want is not None                      # the Pallas body ran
    got = E.edgeconv_backward_plain(
        *(torch.from_numpy(a) for a in (nbr, ctr, *ws, g)), agg)
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=3e-5,
                                   atol=3e-5, err_msg=f"gradient {i}")
    if ties:
        assert torch.equal(got[0][:, 1], got[0][:, 0])
        assert torch.equal(got[0][:, 5], got[0][:, 3])
        assert float(got[0][:, 0].abs().max()) > 0


@pytest.mark.parametrize("dtype,mlp,widths,tiled", [
    (torch.float32, True, (64, 128, 256), True),
    (torch.bfloat16, True, (64, 128, 256), False),
    (torch.float16, True, (64, 128, 256), False),
    (torch.float32, False, (64, 128, 128), True),
    (torch.float32, False, (64, 128, 256), False),
    (torch.float32, True, (6, 64, 128), True),
    (torch.float32, True, (3, 64, 128), True),
    (torch.bfloat16, True, (3, 64, 128), False),
    (torch.float32, False, (3, 64, 128), False),
    (torch.float32, True, (32, 16, 32), True),
    (torch.float32, True, (64, 128, 128), False),
    (torch.bfloat16, False, (64, 128, 128), False),
    (torch.bfloat16, True, (6, 64, 128), False),
    (torch.bfloat16, True, (32, 16, 32), False),
    (torch.float32, True, (6, 64, 256), False),
    (torch.float32, True, (8, 64, 128), False),
    (torch.float32, True, (32, 16, 64), False),
    (torch.float32, True, (32, 32, 32), False),
    (torch.float32, False, (64, 64, 64), False),
    (torch.float32, False, (32, 16, 16), False),
])
def test_tiled_backward_dispatch(dtype, mlp, widths, tiled):
    """Only the f32 backward at a class of F32_TILED_BWD_CLASSES (every f32
    class of the fused train step: the upsampler's and mask head's, the
    mask head's sum, EdgeConv_0's and the IDGCN's, and the action
    generator's EdgeConv_0) takes the redesigned kernel; bf16, another
    width or another SharedMLP setting does not; the aggregate does not
    enter the choice."""
    assert E.F32_TILED_BWD_CLASSES == frozenset({
        (True, 64, 128, 256), (False, 64, 128, 128), (True, 6, 64, 128),
        (True, 32, 16, 32), (True, 3, 64, 128)})
    for _ in E.AGGREGATES:
        assert E.takes_f32_tiled_bwd(dtype, mlp, *widths) is tiled


@pytest.mark.parametrize("b,k,n", [(12, 12, 1152), (12, 4, 1152),
                                   (2, 12, 77), (1, 1, 1), (3, 5, 13),
                                   (1, 20, 4097)])
def test_tiled_backward_plan(b, k, n):
    """Each dW product's splits cover the R = b k n rows once, in order, in
    ranges of a multiple of 8 rows; about DW_BLOCKS blocks run at the train
    shapes; the row products' tiles cover the rows; the partials and the
    scratch are the formulas' sizes."""
    plan = E.tiled_bwd_plan(b, k, n)
    rows = b * k * n
    assert plan["rows"] == rows
    assert plan["row_tiles"] * E.BWD_ROW_TILE >= rows > (
        plan["row_tiles"] - 1) * E.BWD_ROW_TILE
    assert plan["dw"] == [(H, O), (H, H), (C, H), (C, H)]
    part = 0
    for (m, nn), sr, splits in zip(plan["dw"], plan["split_rows"],
                                   plan["splits"]):
        assert sr % E.DW_BK == 0
        ranges = E.split_ranges(rows, sr)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        assert all(r1 == r0n for (_, r1), (r0n, _) in zip(ranges, ranges[1:]))
        assert all(r1 - r0 == sr for r0, r1 in ranges[:-1])
        assert 0 < ranges[-1][1] - ranges[-1][0] <= sr
        blocks = splits * (m // min(m, 128)) * (nn // 128)
        assert blocks <= E.DW_BLOCKS + nn // 128
        if rows >= E.DW_BLOCKS * E.DW_MIN_ROWS:
            assert blocks >= E.DW_BLOCKS // 2
        part = max(part, splits * m * nn)
    assert plan["part_floats"] == part
    assert 4 * plan["scratch_floats"] == rows * (4 * (2 * H + O + C)
                                                 + 4 * E.SIGN_WORDS)


def test_tiled_backward_plan_refuses_32_bit_overflow():
    with pytest.raises(ValueError, match="plane-rows"):
        E.tiled_bwd_plan(1, 1, 2 ** 31 // O)
