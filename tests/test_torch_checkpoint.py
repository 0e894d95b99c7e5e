"""The port's flax msgpack reader and SRNet weight bridge.

``read_flax_msgpack`` is held bit for bit against
``flax.serialization.msgpack_restore``; the bridge is held against the JAX
SRNet on the trained serving checkpoint.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from tpugan_tpu.models import SRNet as JaxSRNet
from tpugan_tpu_torch.checkpoint import (load_srnet, read_flax_msgpack,
                                         srnet_params_from_flax)
from tpugan_tpu_torch.models.generator import SRNet

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "fluid_vel_20k.ckpt")


def _assert_same_tree(a, b, path="tree"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def test_read_flax_msgpack_matches_flax_on_checkpoint():
    # the whole trainer state: three nets, three optimizers, the step count
    with open(CKPT, "rb") as fh:
        want = serialization.msgpack_restore(fh.read())
    _assert_same_tree(read_flax_msgpack(CKPT), want)


def test_read_flax_msgpack_covers_flax_encodings(tmp_path, rng):
    tree = {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(70000),                  # bin 32
        "i32": np.arange(-5, 5, dtype=np.int32),
        "u8": np.arange(300, dtype=np.int64).astype(np.uint8),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "np_scalars": {"f": np.float32(1.5), "i": np.int64(-7)},
        "python": {"small": 3, "neg": -3, "neg8": -100, "u16": 40000,
                   "u32": 3_000_000_000, "i64": -(2 ** 40), "u64": 2 ** 63,
                   "float": 0.1, "none": None, "t": True, "f": False,
                   "str": "x" * 40, "long_str": "y" * 70000},
        "list": [1, [2.5, "a"], {"k": np.ones(2, np.float16)}],
        "wide": {f"key_{i}": i for i in range(20)},          # map 16
        "long": list(range(20)),                             # array 16
    }
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    _assert_same_tree(read_flax_msgpack(path),
                      serialization.msgpack_restore(path.read_bytes()))


def test_load_srnet_reads_the_serving_configuration():
    m = load_srnet(CKPT, device="cpu")
    assert (m.in_feats, m.upsample_ratio) == (6, 8)
    fe = m.feature_extractor
    assert fe.EdgeConv_0.ConvLayer_0.Dense_0.weight.shape == (64, 6)
    assert [n for n, _ in fe.named_children()] == [
        "EdgeConv_0", "IDGCNLayer_0", "IDGCNLayer_1"]
    n_params = sum(1 for _ in m.parameters())
    assert n_params == 53   # one per leaf of the flax sr_net/params tree


def test_bridge_fails_loudly_on_mismatched_trees():
    params = read_flax_msgpack(CKPT)["sr_net"]["params"]
    model = SRNet(in_feats=6, node_emb_dim=128, device="cpu")
    extra = dict(params, stray={"Dense_0": {"kernel": np.zeros((2, 2))}})
    with pytest.raises(ValueError, match="without a torch parameter"):
        srnet_params_from_flax(extra, model)
    short = {k: v for k, v in params.items() if k != "filter_block"}
    with pytest.raises(ValueError, match="left unfilled"):
        srnet_params_from_flax(short, model)
    narrow = SRNet(in_feats=6, node_emb_dim=64, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        srnet_params_from_flax(params, narrow)


def test_trained_checkpoint_static_matches_jax():
    # one kNN graph on positions: no feature-space ties, so the forwards
    # agree to f32 noise directly
    pos = (np.random.default_rng(0).standard_normal((1, 10240, 3))
           .astype(np.float32) * 0.3)[:, :1024]
    feat = np.concatenate([pos, np.zeros_like(pos)], -1)
    params = read_flax_msgpack(CKPT)["sr_net"]["params"]
    jm = JaxSRNet(in_feats=6, node_emb_dim=128, upsample_ratio=8,
                  graph_mode="static")
    e_j, m_j, _, v_j = jax.jit(lambda f, p: jm.apply({"params": params}, f, p,
                                                     False))(feat, pos)
    tm = load_srnet(CKPT, device="cpu", graph_mode="static")
    e_t, m_t, _, v_t = tm(torch.from_numpy(feat), torch.from_numpy(pos))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0, atol=1e-4)
    near = np.repeat(np.abs(np.asarray(m_j) - tm.epsilon) < 1e-4, 8, axis=1)
    assert np.all((v_t.numpy() == np.asarray(v_j)) | near)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-4)
