"""Point-sharded serving of the port on two gloo ranks on the CPU, against
the JAX package's ``rollout_sequence_sharded`` on ``make_mesh(2)`` and
against the port's unsharded rollout.

One ``torchrun`` launch of two ranks (``tests/torch_dist_worker.py``, case
``serving``) runs a 3-frame rollout of 300 points, which pads to 512 rows
(a unit of ``ALIGN * 2`` = 256 does not divide 300), pipelined
(``max_pending=4``) and serial (``max_pending=0``), and the rollout CLI
with ``--shard_points --mesh_devices 2``. The generator's graph is static
(one kNN on the input positions, as ``tests/test_torch_rollout.py`` runs
its parity), and each sharded kNN list is first held against the
unsharded kNN of the same gathered cloud: they may differ only between
candidates whose exact distances tie within f32 noise. The frames must
then agree to 1e-5. The same launch runs the dynamic-graph generator (7
kNN graphs a frame, 5 of them in feature space over the gathered
features and their valid mask), held the same way.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (the cores among xdist workers)
from torch_dist_worker import start_ranks
from tpugan_tpu.models import SRNet as JaxSRNet
from tpugan_tpu.parallel import make_mesh
from tpugan_tpu.parallel import rollout_sequence_sharded as jax_sharded
from tpugan_tpu_torch.checkpoint import srnet_params_from_flax
from tpugan_tpu_torch.cli import rollout as rollout_cli
from tpugan_tpu_torch.eval.rollout import (rollout_sequence,
                                           rollout_sequence_device)
from tpugan_tpu_torch.models.generator import SRNet
from tpugan_tpu_torch.ops.neighbors import knn

SRNET = dict(in_feats=6, node_emb_dim=32, upsample_ratio=4,
             graph_mode="static")
DYNAMIC = dict(SRNET, graph_mode="dynamic")
T, N, HISTORY = 3, 300, 5
CLI = ["--use_vel", "--in_node_feats", "6", "--node_embedding", "32",
       "--upsample_ratio", "4", "--graph_mode", "static",
       "--synthetic_particles", str(N), "--num_frames", "2", "--device",
       "cpu"]


def _models(spec):
    """The JAX SRNet of ``spec`` (init at key 3), its params and the port's
    twin with those weights."""
    jm = JaxSRNet(**spec)
    x = np.zeros((1, N, 6), np.float32)
    params = jax.jit(lambda k: jm.init(k, x, x[..., :3], False))(
        jax.random.PRNGKey(3))["params"]
    tm = SRNet(device="cpu", **spec)
    tm.load_state_dict(srnet_params_from_flax(params, tm))
    return jm, params, tm


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(11)
    pos = (rng.standard_normal((T, N, 3)) * 0.3).astype(np.float32)
    vel = rng.standard_normal((T, N, 3)).astype(np.float32)
    jm, params, tm = _models(SRNET)
    jd, dparams, td = _models(DYNAMIC)
    work = tmp_path_factory.mktemp("serving")
    inp = dict(srnet=SRNET, state_dict=tm.state_dict(), pos=pos, vel=vel,
               history=HISTORY,
               dynamic=dict(srnet=DYNAMIC, state_dict=td.state_dict()),
               cli_args=CLI + ["--shard_points", "--mesh_devices", "2",
                               "--out_dir", str(work / "cli")])
    # the ranks run while this process runs the JAX twins
    ranks = start_ranks("serving", inp, work / "ranks")
    mesh = make_mesh(2)
    jax_out = jax_sharded(jm, {"params": params}, pos, vel, mesh=mesh,
                          use_vel=True, history=HISTORY)
    jax_dyn = jax_sharded(jd, {"params": dparams}, pos, vel, mesh=mesh,
                          use_vel=True, history=HISTORY)
    return dict(pos=pos, vel=vel, tm=tm, td=td, outs=ranks(), jax=jax_out,
                jax_dynamic=jax_dyn, cli_dir=str(work / "cli"))


def _assert_ties_only(ranks, frames_graphs):
    """Each graph of both ranks (same gathered cloud and mask) against the
    unsharded kNN of that cloud: indices differ only between candidates
    whose exact distances tie within f32 noise (1e-5 of 2 max |x|^2 over
    the valid rows). Returns the graphs' feature widths."""
    widths = []
    for (x0, i0, v0), (x1, i1, v1) in zip(*ranks):
        assert torch.equal(x0, x1)                  # the same gathered cloud
        assert (v0 is None) == (v1 is None)
        assert v0 is None or torch.equal(v0, v1)
        assert x0.shape[1] == 512
        rec = torch.cat([i0, i1], 1).numpy()
        own = knn(x0, k=rec.shape[-1], c_valid=v0)[1].numpy()
        xf = x0.numpy().astype(np.float64)
        b, r, s = np.nonzero(rec != own)
        exact = lambda idx: np.sum((xf[b, r] - xf[b, idx[b, r, s]]) ** 2, -1)
        tol = 1e-5 * 2 * float(np.max(np.sum(xf[:, :N] ** 2, -1)))
        gap = np.abs(exact(rec) - exact(own))
        assert gap.size == 0 or gap.max() <= tol, (gap.max(), tol)
        widths.append(x0.shape[-1])
    assert len(widths) == frames_graphs
    return widths


def test_sharded_graphs_differ_only_below_f32_noise(case):
    ranks = [o["graphs"] for o in case["outs"]]
    assert len(ranks[0]) == len(ranks[1]) == T      # one static graph a frame
    _assert_ties_only(ranks, T)


def test_sharded_dynamic_graphs_differ_only_below_f32_noise(case):
    """The dynamic generator's 7 graphs a frame: the input positions, the
    feature-space graphs of the IDGCN and the upsampler over the gathered
    features (with the padding rows' valid mask), the mask head's."""
    ranks = [o["dynamic_graphs"] for o in case["outs"]]
    widths = _assert_ties_only(ranks, 7 * T)
    assert sum(w > 3 for w in widths) >= 4 * T      # feature-space graphs


def test_sharded_dynamic_rollout_matches_jax_and_unsharded(case):
    got = case["outs"][0]["dynamic"]
    assert case["outs"][1]["dynamic"] == []         # rank 0 gathers
    want = rollout_sequence_device(case["td"], case["pos"], case["vel"],
                                   use_vel=True, history=HISTORY)
    assert len(got) == len(case["jax_dynamic"]) == len(want) == T
    for a, b, c in zip(got, case["jax_dynamic"], want):
        assert a.shape == b.shape == c.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-5)


def test_sharded_rollout_matches_jax_sharded(case):
    got = case["outs"][0]["piped"]
    assert case["outs"][1]["piped"] == []           # rank 0 gathers
    assert len(got) == len(case["jax"]) == T
    for a, b in zip(got, case["jax"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_sharded_rollout_matches_unsharded(case):
    want = rollout_sequence_device(case["tm"], case["pos"], case["vel"],
                                   use_vel=True, history=HISTORY)
    for a, b in zip(case["outs"][0]["piped"], want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_sharded_rollout_serial_equals_pipelined(case):
    piped, serial = case["outs"][0]["piped"], case["outs"][0]["serial"]
    assert len(serial) == T
    for a, b in zip(piped, serial):
        np.testing.assert_array_equal(a, b)


def test_rollout_cli_shard_points_matches_unsharded(case, tmp_path):
    """``--shard_points`` under torchrun: rank 0 wrote the frames, which
    agree with the unsharded CLI's."""
    got = case["outs"]
    assert [o["cli"]["rank"] for o in got] == [0, 1]
    rollout_cli.main(CLI + ["--out_dir", str(tmp_path)])
    names = sorted(os.listdir(case["cli_dir"]))
    assert names == ["pred_0.npy", "pred_1.npy"]
    for name in names:
        np.testing.assert_allclose(np.load(os.path.join(case["cli_dir"], name)),
                                   np.load(tmp_path / name), rtol=0, atol=1e-5)


def test_rollout_cli_refuses_a_mesh_other_than_the_world(tmp_path):
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        rollout_cli.main(CLI + ["--shard_points", "--mesh_devices", "2",
                                "--out_dir", str(tmp_path)])


def test_max_pending_zero_equals_pipelined(case):
    """``max_pending`` of the unsharded host loop: serial (0: each frame
    fetched before the next is enqueued) and pipelined (one frame left in
    flight, and the default 16, more than the sequence) give the same
    frames bit for bit."""
    tm, pos, vel = case["tm"], case["pos"], case["vel"]
    frames = list(zip(pos, vel))
    kw = dict(use_vel=True, history=HISTORY)
    serial = rollout_sequence(tm, frames, max_pending=0, **kw)
    for piped in (rollout_sequence(tm, frames, max_pending=1, **kw),
                  rollout_sequence(tm, frames, **kw)):
        assert len(serial) == len(piped) == T
        for a, b in zip(serial, piped):
            np.testing.assert_array_equal(a, b)
