"""The port's point-sharded neighbour ops and its collectives on two gloo
ranks on the CPU, against the JAX package's ``parallel.sharded_ops`` on
``make_mesh(2)``.

One ``torchrun`` launch of two ranks (``tests/torch_dist_worker.py``, case
``ops``) runs every case; each rank takes its contiguous N-rows of the
same numpy clouds. kNN and ball-query indices must equal the JAX twins'
exactly (they are global indices into the gathered cloud); distances and
Chamfer sums within 1e-6 relative. The collectives' gradients are held
against their closed forms, and the point-shard context against the
unsharded ops of the global cloud.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (the cores among xdist workers)
from torch_dist_worker import run_ranks
from tpugan_tpu.parallel import make_mesh
from tpugan_tpu.parallel import sharded_ball_query as jax_ball_query
from tpugan_tpu.parallel import sharded_chamfer as jax_chamfer
from tpugan_tpu.parallel import sharded_knn as jax_knn
from tpugan_tpu_torch.ops import neighbors
from tpugan_tpu_torch.ops.neighbors import gather, knn
from tpugan_tpu_torch.parallel import mesh
from tpugan_tpu_torch.train.step import FluidGanStep, FluidTrainConfig

B, N, K, RADIUS, NSAMPLE = 2, 256, 8, 0.3, 16


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    inp = dict(q=t(q), c=t(c), k=K, radius=RADIUS, nsample=NSAMPLE,
               x=t(rng.standard_normal((4, 3))),
               coef_gather=t(rng.standard_normal((2, 4, 3))),
               coef_reduce=t(rng.standard_normal((2, 4, 3))),
               grads=t(rng.standard_normal((2, 7))),
               batch=np.arange(3 * 4 * 2, dtype=np.float32).reshape(3, 4, 2))
    outs = run_ranks("ops", inp, tmp_path_factory.mktemp("ops"))
    return inp, q, c, outs


def _cat(outs, key, item=None):
    return torch.cat([o[key] if item is None else o[key][item]
                      for o in outs], 1).numpy()


def test_sharded_knn_matches_jax(case):
    _, q, c, outs = case
    d2_j, idx_j = jax_knn(q, c, K, make_mesh(2))
    np.testing.assert_array_equal(_cat(outs, "knn", 1), np.asarray(idx_j))
    np.testing.assert_allclose(_cat(outs, "knn", 0), np.asarray(d2_j),
                               rtol=1e-6, atol=1e-7)


def test_sharded_ball_query_matches_jax(case):
    _, q, c, outs = case
    idx_j = jax_ball_query(q, c, RADIUS, NSAMPLE, make_mesh(2))
    np.testing.assert_array_equal(_cat(outs, "ball"), np.asarray(idx_j))


def test_sharded_chamfer_matches_jax(case):
    _, q, c, outs = case
    want = np.asarray(jax_chamfer(q, c, make_mesh(2)))
    for o in outs:                   # every rank holds the total
        np.testing.assert_allclose(o["chamfer"].numpy(), want, rtol=1e-6)


def test_point_shard_context_gives_global_indices(case):
    """Under the context each rank's graph is its rows of the global
    cloud's graph, and ``gather`` reads the gathered table."""
    inp, _, _, outs = case
    d2, idx = knn(inp["q"], k=K)
    np.testing.assert_array_equal(_cat(outs, "graph_knn", 1), idx.numpy())
    np.testing.assert_allclose(_cat(outs, "graph_knn", 0), d2.numpy(),
                               rtol=1e-6, atol=1e-7)
    got = torch.cat([o["gather"] for o in outs], 1)
    want = gather(inp["c"], idx.reshape(B, -1))
    assert torch.equal(got, want)


def test_point_shard_context_off_is_local(case):
    """Outside the context a rank's graph is its own rows' (no gathered
    candidates), and the context is restored after use."""
    inp, _, _, outs = case
    for r, o in enumerate(outs):
        rows = slice(r * N // 2, (r + 1) * N // 2)
        d2, idx = knn(inp["q"][:, rows], k=K)
        assert torch.equal(o["outside"][1], idx)
    assert neighbors._POINT_SHARD_AXIS is None
    with neighbors.point_shard_axis(mesh.DATA_AXIS):
        assert neighbors._POINT_SHARD_AXIS == mesh.DATA_AXIS
    assert neighbors._POINT_SHARD_AXIS is None


def test_collectives_carry_the_other_ranks_gradients(case):
    """all_gather: rank r's gradient is its rows of the summed
    coefficients; all_reduce: the sum over ranks of each rank's
    coefficient on its own rows."""
    inp, _, _, outs = case
    summed = inp["coef_gather"].sum(0)
    reduced = inp["coef_reduce"][0][:2] + inp["coef_reduce"][1][2:]
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["grad_gather"], summed[2 * r:2 * r + 2],
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(o["grad_reduce"], reduced,
                                   rtol=1e-6, atol=1e-6)


def test_average_gradients_is_the_mean(case):
    inp, _, _, outs = case
    for o in outs:
        torch.testing.assert_close(o["average"]["a"], inp["grads"].mean(0),
                                   rtol=1e-6, atol=1e-7)
        assert o["average"]["b"] is None
    assert torch.equal(outs[0]["average"]["a"], outs[1]["average"]["a"])


def test_batch_split_takes_contiguous_rows(case):
    inp, _, _, outs = case
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["batch"]["x"],
                                      inp["batch"][:, 2 * r:2 * r + 2])
        assert o["batch"]["h"] == 1
        assert "does not divide over 2 ranks" in o["uneven"]


def test_one_process_without_torchrun(monkeypatch):
    """No torchrun variables: a world of one and no group; an incomplete
    set raises; a data-parallel step without a group raises."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.initialize_distributed(device="cpu") == 1
    assert not mesh.is_distributed()
    assert (mesh.world_size(), mesh.rank()) == (1, 0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        mesh.initialize_distributed(device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        FluidGanStep(FluidTrainConfig(), data_parallel=True)


@pytest.mark.parametrize("local, cards, device, shared", [
    (None, 1, None, False),       # no torchrun: one process
    (1, 1, "cuda:0", False),      # one rank on its card: NCCL
    (2, 1, None, True),           # two ranks, one card
    (2, 2, None, False),          # a card each
    (2, 4, "cuda:0", True),       # both ranks told to take card 0
])
def test_ranks_sharing_a_card_take_gloo(monkeypatch, local, cards, device,
                                        shared):
    """``shares_a_card`` (the backend ``initialize_distributed`` picks for
    a CUDA device: gloo where it is True, NCCL otherwise) from torchrun's
    ``LOCAL_WORLD_SIZE``, the number of cards and the device named."""
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh.shares_a_card(device) is shared
