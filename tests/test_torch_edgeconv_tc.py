"""The bf16 tensor-core EdgeConv forward's narrow classes and the serving
path around them, on the CPU (plain versions).

- EdgeConv_0's 6 channels pad to one k16 step on the card with zero
  channels and zero weight rows: the padded function equals the unpadded
  one bit for bit in bf16, at every aggregate.
- The EdgeConv module hands the kernel weights made ready once while
  autograd is off (``EdgeConv._kernel_weights``): the same bits as the
  transposed views it passed before, remade when a parameter changes, and
  with autograd on still the views, so gradients reach the parameters.
- With autograd off, ``edgeconv_fused`` runs without its autograd
  Function (no graph) and gives the same output.
- The rollout step runs without autograd and gives the frames it gave
  with it.
The bf16 parity of these classes with the JAX kernel is held by
``tests/test_torch_kernels.py::test_edgeconv_matches_jax``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpugan_tpu_torch.eval.rollout import make_rollout_step
from tpugan_tpu_torch.models.generator import RolloutMaskState, SRNet
from tpugan_tpu_torch.nn.edgeconv import EdgeConv, gather_neighbor_major
from tpugan_tpu_torch.ops.kernels import edgeconv as E

AGGREGATES = ("max", "min", "sum", "mean")


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("aggregate", AGGREGATES)
def test_channel_padding_is_exact_in_bf16(rng, aggregate):
    b, k, n, c, cp, h, o = 2, 5, 37, 6, 16, 64, 128
    nbr, ctr = _t(rng, b, k, n, c), _t(rng, b, n, c)
    wn, we = _t(rng, c, h) / c ** 0.5, _t(rng, c, h) / c ** 0.5
    w1, w2 = _t(rng, h, h) / h ** 0.5, _t(rng, h, o) / h ** 0.5
    pad = lambda x: F.pad(x, (0, cp - c))          # channels past C are 0
    pad_rows = lambda w: F.pad(w, (0, 0, 0, cp - c))   # weight rows past C
    bf = torch.bfloat16
    want = E.edgeconv_plain(nbr.to(bf), ctr.to(bf), wn, we, w1, w2,
                            aggregate, bf)
    got = E.edgeconv_plain(pad(nbr).to(bf), pad(ctr).to(bf), pad_rows(wn),
                           pad_rows(we), w1, w2, aggregate, bf)
    assert got.dtype == bf
    assert torch.equal(got, want)


def _module(mlp, dtype, seed=0):
    kw = dict(k=6, dtype=dtype, generator=torch.Generator().manual_seed(seed),
              device="cpu")
    if mlp:
        return EdgeConv(8, 32, **kw)
    return EdgeConv(8, 32, mlp_layer=False, aggregate="sum", **kw)


def _before(module, feat, idx):
    """The module's fused forward as it was written before the cache: the
    transposed views of the parameters, converted by the wrapper."""
    w = lambda conv: conv.Dense_0.weight.t()
    mlp = module.mlp_layer
    w1 = w(module.SharedMLP_0.ConvLayer_0) if mlp else None
    w2 = w(module.SharedMLP_0.ConvLayer_1) if mlp else None
    feat = feat.to(module.dtype) if module.dtype is not None else feat
    y = E.edgeconv_fused(gather_neighbor_major(feat, idx), feat,
                         w(module.ConvLayer_0), w(module.ConvLayer_1), w1, w2,
                         aggregate=module.aggregate, compute_dtype=feat.dtype)
    return y if mlp else module.ConvLayer_2(y)


def _inputs(rng, n=40, k=6):
    feat = _t(rng, 2, n, 8)
    idx = torch.from_numpy(rng.integers(0, n, (2, n, k)))
    return feat, idx


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("mlp", [True, False])
def test_serving_weights_are_cached_bit_for_bit(rng, mlp, dtype):
    module = _module(mlp, dtype)
    feat, idx = _inputs(rng)
    with torch.no_grad():
        want = _before(module, feat, idx)
        got = module(feat, idx=idx)
        cached = module._weight_cache[2]
        again = module(feat, idx=idx)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert module._weight_cache[2] is cached          # made once
    cdt = dtype or torch.float32
    assert len(cached) == (4 if mlp else 2)
    assert all(w.dtype == cdt and w.is_contiguous() for w in cached)


@pytest.mark.parametrize("change", ["load_state_dict", "in_place"])
def test_serving_weights_follow_a_parameter_change(rng, change):
    module = _module(True, torch.bfloat16)
    other = _module(True, torch.bfloat16, seed=1)
    feat, idx = _inputs(rng)
    with torch.no_grad():
        first = module(feat, idx=idx)
        if change == "load_state_dict":
            module.load_state_dict(other.state_dict())
        else:
            module.SharedMLP_0.ConvLayer_1.Dense_0.weight.mul_(-0.5)
        second = module(feat, idx=idx)
        want = _before(module, feat, idx)
    assert not torch.equal(first, second)
    assert torch.equal(second, want)


@pytest.mark.parametrize("mlp", [True, False])
def test_weights_take_their_gradient_with_autograd_on(rng, mlp):
    module = _module(mlp, torch.bfloat16)
    module.fused_train = True
    feat, idx = _inputs(rng)
    cot = _t(rng, 2, 40, 32)
    params = [p for p in module.parameters()]
    want = torch.autograd.grad((_before(module, feat, idx).float()
                                * cot).sum(), params)
    out = module(feat, idx=idx, train=True)
    assert module._weight_cache is None               # views, not the cache
    got = torch.autograd.grad((out.float() * cot).sum(), params)
    for g, w in zip(got, want):
        assert g is not None and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_forward_without_autograd_records_nothing(rng, dtype):
    nbr, ctr = _t(rng, 2, 5, 30, 6).to(dtype), _t(rng, 2, 30, 6).to(dtype)
    ws = [(_t(rng, *s) / s[0] ** 0.5).requires_grad_()
          for s in ((6, 64), (6, 64), (64, 64), (64, 128))]
    with torch.no_grad():
        off = E.edgeconv_fused(nbr, ctr, *ws, aggregate="max",
                               compute_dtype=dtype)
    on = E.edgeconv_fused(nbr, ctr, *ws, aggregate="max", compute_dtype=dtype)
    assert off.grad_fn is None and on.grad_fn is not None
    assert torch.equal(off, on.detach())


def test_rollout_step_runs_without_autograd(rng):
    model = SRNet(in_feats=6, node_emb_dim=32, upsample_ratio=4,
                  graph_mode="static", compute_dtype=torch.bfloat16,
                  device="cpu")
    n, bucket = 90, 128
    pos = torch.full((1, bucket, 3), 999.0)
    pos[0, :n] = _t(rng, n, 3) * 0.3
    vel = torch.zeros(1, bucket, 3)
    vel[0, :n] = _t(rng, n, 3)
    step = make_rollout_step(model, use_vel=True)
    states = [RolloutMaskState.create(1, bucket, 3, device="cpu")
              for _ in range(2)]
    for _ in range(2):   # two frames: the second reads the cached weights
        with torch.enable_grad():
            out, valid, states[0] = step(states[0], pos, vel, n)
            # the step as written before, with autograd on
            out_b, valid_b, states[1] = step.__wrapped__(states[1], pos, vel, n)
        assert not out.requires_grad and not valid.requires_grad
        assert torch.equal(out, out_b) and torch.equal(valid, valid_b)
