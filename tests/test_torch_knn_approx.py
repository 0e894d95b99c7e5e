"""The approximate bf16 graph kNN (``knn_pallas(approx=True)``) and its port.

The port's plain version of the approximate kernel against the TPU kernel
run in interpret mode, its dispatch and switch against the JAX package's,
and a narrow SRNet at 4,096 inputs with the switch on against the JAX
forward with its graphs built by the approximate TPU kernel.

Tolerance. On exact inputs (integer grid coordinates) both sides equal bit
for bit. On random inputs the two sides round |q|^2 + |c|^2 - 2 q.c in f32
in another order (within ``tol`` = 1e-5 * 2 max |p|^2), so a distance
whose f32 value lies within ``tol`` of a bf16 rounding boundary may round
to either neighbour of it: each side's d2 must lie within half a bf16 ulp
plus ``tol`` of the float64 value, equal indices must carry equal d2 unless
their distance lies that near a boundary, and a query whose lists differ
must hold such a candidate among the two sides' neighbours, and be at most
2% of the queries (``kernels.knn.approx_agreement``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpugan_tpu.nn.edgeconv as jax_edgeconv_mod
import tpugan_tpu.ops.neighbors as jax_neighbors
import tpugan_tpu.ops.pallas.knn_kernel as jax_knn_kernel
import tpugan_tpu_torch.models.generator as torch_generator
import tpugan_tpu_torch.nn.edgeconv as torch_edgeconv_mod
import tpugan_tpu_torch.ops.neighbors as neighbors
from tpugan_tpu.models import SRNet as JaxSRNet
from tpugan_tpu_torch import PAD_SENTINEL
from tpugan_tpu_torch.checkpoint import srnet_params_from_flax
from tpugan_tpu_torch.models.generator import SRNet
from tpugan_tpu_torch.ops.kernels import knn as K

from test_torch_srnet import _frame, assert_forward_close

BIG = 1e10


def jax_approx(q, c, bias, k):
    """knn_pallas(approx=True) in interpret mode, as numpy (d2, int64 idx)."""
    d2, idx = jax_knn_kernel.knn_pallas(jnp.asarray(q), jnp.asarray(c),
                                        jnp.asarray(bias), k, True)
    return np.asarray(d2), np.asarray(idx).astype(np.int64)


def assert_approx_close(got, want, got_in, want_in=None):
    """The module docstring's tolerance (``kernels.knn.approx_agreement``)
    between results (d2, idx) from numpy inputs (q, c, bias)."""
    t = lambda xs: None if xs is None else [torch.from_numpy(np.array(x))
                                            for x in xs]
    a = K.approx_agreement(t(got), t(want), t(got_in), t(want_in))
    assert a["d2_excess"] <= 0 and a["d2_unexplained"] == 0, a
    assert a["rows_unexplained"] == 0 and a["rows"] <= 0.02 * a["queries"], a


# (B, Nq, Nc, D, k, invalid tail): D in {3, 32, 64}, k in {4, 8, 12, 20},
# Nc in {4096, 10240}, with and without an invalid tail, Nq off the
# 128-row tile; the serving shapes' (D, k) pairs among them
CASES = [
    (1, 130, 4096, 3, 20, 0),
    (1, 200, 4096, 3, 12, 300),
    (1, 130, 10240, 3, 20, 128),      # one lane row of invalid candidates
    (1, 130, 4096, 32, 20, 0),
    (2, 130, 10240, 32, 8, 1000),
    (1, 130, 10240, 64, 12, 0),
    (2, 200, 4096, 64, 4, 1000),
    (1, 130, 10240, 64, 8, 0),
    (1, 130, 10240, 64, 4, 300),
    (1, 130, 4096, 64, 20, 300),
]


def _inputs(b, nq, nc, d, tail, seed=0):
    """Candidates drawn from a seeded normal (0.3 for points), queries the
    first Nq of them (a self graph's rows), the last ``tail`` invalid."""
    rng = np.random.default_rng(seed)
    c = (rng.standard_normal((b, nc, d)) * (0.3 if d == 3 else 1.0)
         ).astype(np.float32)
    bias = np.zeros((b, nc), np.float32)
    if tail:
        bias[:, nc - tail:] = BIG
    return np.ascontiguousarray(c[:, :nq]), c, bias


@pytest.fixture(scope="module")
def jax_cases():
    """One knn_pallas(approx=True) call per case, shared by the tests."""
    out = {}
    for case in CASES:
        b, nq, nc, d, k, tail = case
        q, c, bias = _inputs(b, nq, nc, d, tail)
        out[case] = (q, c, bias, jax_approx(q, c, bias, k))
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}-nq{}-nc{}-d{}-k{}-tail{}".format(*c))
def test_plain_matches_tpu_kernel(jax_cases, case):
    q, c, bias, want = jax_cases[case]
    k = case[4]
    assert K.takes_approx(c.shape[1], k)
    d2, idx = K.knn_approx_kernel(torch.from_numpy(q), torch.from_numpy(c),
                                  torch.from_numpy(bias), k)
    assert_approx_close((d2.numpy(), idx.numpy()), want, (q, c, bias))
    # invalid candidates never enter while valid ones remain
    assert np.all(bias[0, idx[0].numpy()] == 0)


def test_plain_matches_tpu_kernel_on_a_sentinel_padded_frame():
    """The rollout's frame: 10,000 points padded to 10,112 rows at the 999
    sentinel with no invalid bias (its graphs carry no valid mask). Real
    queries pick real neighbours only, under the tolerance of the real
    points' norms; sentinel queries tie at d2 = 0 and equal bit for bit."""
    real, nc = 10000, 10112
    _, c, bias = _inputs(1, 0, nc, 3, 0, seed=11)
    c[:, real:] = PAD_SENTINEL
    q = np.ascontiguousarray(np.concatenate([c[:, :66], c[:, -64:]], 1))
    want = jax_approx(q, c, bias, 20)
    d2, idx = K.knn_approx_kernel(torch.from_numpy(q), torch.from_numpy(c),
                                  torch.from_numpy(bias), 20)
    d2, idx = d2.numpy(), idx.numpy()
    np.testing.assert_array_equal(d2[:, 66:], want[0][:, 66:])
    np.testing.assert_array_equal(idx[:, 66:], want[1][:, 66:])
    assert idx[:, :66].max() < real and want[1][:, :66].max() < real
    assert_approx_close((d2[:, :66], idx[:, :66]),
                        (want[0][:, :66], want[1][:, :66]),
                        (q[:, :66], c[:, :real], bias[:, :real]))


def _grid():
    """The 16^3 integer grid, every point twice (8,192 points): exact
    distances and exact ties; 260 queries spread over it."""
    g = np.stack(np.meshgrid(*[np.arange(16.0)] * 3, indexing="ij"), -1)
    c = np.concatenate([g.reshape(-1, 3)] * 2)[None].astype(np.float32)
    return np.ascontiguousarray(c[:, ::31][:, :260]), c


def test_grid_bit_for_bit():
    q, c = _grid()
    bias = np.zeros(c.shape[:2], np.float32)
    want = jax_approx(q, c, bias, 20)
    d2, idx = K.knn_approx_plain(torch.from_numpy(q), torch.from_numpy(c),
                                 torch.from_numpy(bias), 20)
    np.testing.assert_array_equal(d2.numpy(), want[0])
    np.testing.assert_array_equal(idx.numpy(), want[1])


def _dropped_case():
    """A query at the origin whose 4 nearest candidates are 5, 133 and 261
    (all in lane column 5) and 7; every other candidate lies 2-3 away.
    With k = 4 the approximate mode keeps 2 keys a column and drops 261."""
    rng = np.random.default_rng(3)
    nc = 4096
    dirs = rng.standard_normal((nc, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    c = dirs * rng.uniform(2.0, 3.0, (nc, 1))
    for i, r in ((5, 0.125), (133, 0.25), (261, 0.375), (7, 0.5)):
        c[i] = (r, 0.0, 0.0)
    return np.zeros((1, 1, 3), np.float32), c[None].astype(np.float32)


def test_column_overflow_drops_the_same_neighbour():
    q, c = _dropped_case()
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    bias = np.zeros((1, c.shape[1]), np.float32)
    want = jax_approx(q, c, bias, 4)
    plain = K.knn_approx_plain(qt, ct, torch.from_numpy(bias), 4)
    via_knn = neighbors.knn(qt, ct, k=4, approx=True)
    exact = neighbors.knn(qt, ct, k=4)
    assert list(want[1][0, 0, :3]) == [5, 133, 7] and 261 not in want[1]
    for d2, idx in (plain, via_knn):
        np.testing.assert_array_equal(idx.numpy(), want[1])
        np.testing.assert_array_equal(d2.numpy(), want[0])
    assert exact[1][0, 0].tolist() == [5, 133, 261, 7]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 12, 15, 16, 20, 32, 64])
def test_dispatch_rules_match_jax(k):
    assert K.chunk_kp_approx(k) == jax_knn_kernel._chunk_kp_approx(k)
    for nc in (128, 3968, 4000, 4095, 4096, 4160, 4224, 10239, 10240,
               24576, 24704, 30000):
        assert K.takes_approx(nc, k) == jax_knn_kernel._use_chunked(nc, k, 3)
    assert K.PALLAS_MAX_NC == jax_neighbors._PALLAS_MAX_NC


@pytest.mark.parametrize("nc,k,approx", [
    (4096, 8, True), (10240, 20, True), (24576, 3, True),
    (3968, 8, False),      # nc < 4096
    (4160, 8, False),      # nc % 128 != 0
    (4096, 2, False),      # k < 3
    (24704, 8, False),     # nc > 24,576
])
def test_knn_takes_the_approximate_kernel_only_at_its_shapes(monkeypatch, nc,
                                                             k, approx):
    calls = []

    def spy(*args):
        calls.append(args[3])
        return K.knn_approx_kernel(*args)

    monkeypatch.setattr(neighbors, "knn_approx_kernel", spy)
    q, c, bias = _inputs(1, 40, nc, 3, 0, seed=nc + k)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    got = neighbors.knn(qt, ct, k=k, approx=True)
    want = (K.knn_approx_plain(qt, ct, torch.from_numpy(bias), k) if approx
            else neighbors.knn(qt, ct, k=k))
    assert calls == ([k] if approx else [])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert torch.equal(got[1], want[1])


def test_switch_defaults_off_and_graph_knn_honours_it(monkeypatch):
    assert neighbors.APPROX_GRAPH_KNN is False
    _, c, bias = _inputs(1, 4096, 4096, 3, 0, seed=5)
    x = torch.from_numpy(c)
    exact = neighbors.graph_knn(x, 20)
    torch.testing.assert_close(exact[0], neighbors.knn(x, k=20)[0], rtol=0,
                               atol=0)
    monkeypatch.setattr(neighbors, "APPROX_GRAPH_KNN", False)
    neighbors.set_approx_graph_knn(True)
    assert neighbors.APPROX_GRAPH_KNN is True
    approx = neighbors.graph_knn(x, 20)
    want = K.knn_approx_plain(x, x, torch.from_numpy(bias), 20)
    assert torch.equal(approx[0], want[0]) and torch.equal(approx[1], want[1])
    assert not torch.equal(approx[0], exact[0])   # bf16 distances
    neighbors.set_approx_graph_knn(False)
    assert torch.equal(neighbors.graph_knn(x, 20)[1], exact[1])


def test_srnet_with_approx_graphs_matches_jax(monkeypatch):
    """A narrow SRNet (width 32, r 4) at 4,096 inputs with the switch on:
    every one of its 7 graphs takes the approximate kernel. The JAX
    forward builds its graphs with knn_pallas(approx=True); each of the
    port's graphs is held against the JAX one under the tolerance, then
    the JAX graphs are replayed and the outputs compared to f32 noise."""
    import jax

    r = 4
    feat, pos = _frame(np.random.default_rng(7), 4096, 6)
    traced = []

    def jax_graph_knn(x, k, c_valid=None):
        assert c_valid is None
        x = x.astype(jnp.float32)
        out = jax_knn_kernel.knn_pallas(x, x, jnp.zeros(x.shape[:2]), k, True)
        traced.append((*out, x))
        return out

    monkeypatch.setattr(jax_neighbors, "graph_knn", jax_graph_knn)
    monkeypatch.setattr(jax_edgeconv_mod, "graph_knn", jax_graph_knn)
    jm = JaxSRNet(in_feats=6, node_emb_dim=32, upsample_ratio=r)
    variables = jax.jit(lambda key: jm.init(key, feat[:, :256], pos[:, :256],
                                            False))(jax.random.PRNGKey(0))

    def fwd(v, f, p):
        traced.clear()
        return jm.apply(v, f, p, False), list(traced)

    out_j, graphs = jax.jit(fwd)(variables, feat, pos)
    graphs = [(np.asarray(d2), np.asarray(idx).astype(np.int64), np.asarray(x))
              for d2, idx, x in graphs]
    assert len(graphs) == 7

    own_graph_knn = neighbors.graph_knn
    ks = []

    def replaying(x, k, c_valid=None):
        d2, own = own_graph_knn(x, k, c_valid)
        d2_j, idx_j, x_j = graphs.pop(0)
        xn = x.detach().float().numpy()
        bias = np.zeros(xn.shape[:2], np.float32)
        assert_approx_close((d2.numpy(), own.numpy()), (d2_j, idx_j),
                            (xn, xn, bias), (x_j, x_j, bias))
        ks.append(k)
        return d2, torch.from_numpy(idx_j)

    monkeypatch.setattr(torch_edgeconv_mod, "graph_knn", replaying)
    monkeypatch.setattr(torch_generator, "graph_knn", replaying)
    monkeypatch.setattr(neighbors, "APPROX_GRAPH_KNN", True)
    tm = SRNet(in_feats=6, node_emb_dim=32, upsample_ratio=r, device="cpu")
    tm.load_state_dict(srnet_params_from_flax(variables["params"], tm))
    out_t = tm(torch.from_numpy(feat), torch.from_numpy(pos))
    assert not graphs and sorted(ks) == [4, 8, 12, 12, 20, 20, 20]
    assert_forward_close(out_j, out_t, tm.epsilon, r)
