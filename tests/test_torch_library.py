"""The port's library functions that no model path of the other tests
reaches, against the JAX package's, on seeded numpy inputs at small widths:

* the geometry losses (``losses/geometry.py``) and their gradients in the
  points: f32 values to rtol 1e-5 / atol 1e-6, gradients to ``GRAD_TOL``
  of their scale; the kNN and Chamfer they search with are the kernels'
  plain versions here;
* the graph builders (``ops/neighbors.py``): identical indices and masks on
  tie-free clouds;
* the SPH weights ``exponential_kernel`` and ``linear_kernel``;
* the ``MLP`` head (spectral norm, activation first) and the multi-scale
  ``SetConv`` (train and eval, fused and plain), loaded from the flax
  parameters through ``state_dict_from_flax``;
* the auction's ``theta`` and ``final_iters``: each side's cost within
  n eps of the optimum (scipy's Hungarian solver), as
  ``tests/test_torch_eval.py`` holds the auction; its per-item split;
* the sampling functions (``data/sampling.py``): identical arrays from the
  same numpy generator;
* ``param_count`` against the JAX package's for the fluid networks, and
  the train CLI's totals;
* the step helpers ``get_rotation_matrix``, ``advect_particle`` and
  ``rotate_lst`` (the port's draw from a ``torch.Generator``; the same
  angles give the JAX package's matrices).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import tpugan_tpu.data.sampling as jsampling
import tpugan_tpu.losses.geometry as jgeo
import tpugan_tpu.ops.interpolate as jinterp
import tpugan_tpu.ops.metrics as jmetrics
import tpugan_tpu.ops.neighbors as jnbr
import tpugan_tpu.train.step as jstep
from test_torch_discriminator import _features, compare
from tpugan_tpu.config import FluidTrainConfig as JFluidTrainConfig
from tpugan_tpu.nn.layers import MLP as JMLP
from tpugan_tpu.nn.layers import leaky_relu_001 as j_lrelu
from tpugan_tpu.nn.setconv import SetConv as JSetConv
from tpugan_tpu.train import init_fluid_state as jax_init_fluid_state
from tpugan_tpu.train.state import param_count as jax_param_count
import tpugan_tpu_torch.data.sampling as sampling
import tpugan_tpu_torch.losses.geometry as geo
import tpugan_tpu_torch.ops.interpolate as interp
import tpugan_tpu_torch.ops.metrics as metrics
import tpugan_tpu_torch.ops.neighbors as nbr
import tpugan_tpu_torch.train.step as step
from tpugan_tpu_torch.checkpoint import state_dict_from_flax
from tpugan_tpu_torch.cli.train_fluid import print_network_sizes
from tpugan_tpu_torch.nn.layers import MLP, leaky_relu_001, relu
from tpugan_tpu_torch.nn.setconv import SetConv
from tpugan_tpu_torch.train.state import init_fluid_state, param_count
from test_torch_train_step import port_config

T = torch.from_numpy
RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 5e-4


def _cloud(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if
                                          isinstance(got, torch.Tensor)
                                          else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def _grad_close(got, want):
    """Gradients to GRAD_TOL of their scale: both sides form a distance as
    |q|^2 + |c|^2 - 2 q.c, whose rounding (the dot product's order differs)
    moves a close pair's distance by up to about 1e-3 of itself, and the
    losses divide by the distance."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0,
        atol=GRAD_TOL * max(1.0, float(np.abs(want).max())))


def _value_and_grad(jfn, tfn, *arrays):
    """(port value, JAX value) and the gradients in the first array, of a
    scalar loss."""
    jv, jg = jax.value_and_grad(jfn)(*[jnp.asarray(a) for a in arrays])
    x = T(arrays[0].copy()).requires_grad_()
    tv = tfn(x, *[T(a.copy()) for a in arrays[1:]])
    tv.backward()
    return tv, jv, x.grad, jg


# ---------------------------------------------------------------- losses

# (name, port, JAX, arrays from rng): each a scalar of the points
LOSSES = [
    ("repulsion", lambda p: geo.repulsion_loss(p, 0.05),
     lambda p: jgeo.repulsion_loss(p, 0.05), lambda r: [_cloud(r, 2, 300, 3)]),
    ("repulsion 2-D", lambda p: geo.repulsion_loss(p, 0.05, 2.0),
     lambda p: jgeo.repulsion_loss(p, 0.05, 2.0), lambda r: [_cloud(r, 300, 3)]),
    ("density_loss", lambda p: geo.density_loss(p, 0.04),
     lambda p: jgeo.density_loss(p, 0.04), lambda r: [_cloud(r, 2, 300, 3)]),
    ("refinement", lambda p, f: geo.refinement_loss(0.5, f, p, 0.04)[0],
     lambda p, f: jgeo.refinement_loss(0.5, f, p, 0.04)[0],
     lambda r: [_cloud(r, 2, 200, 3), _cloud(r, 2, 60, 3)]),
    ("dense", lambda p: geo.dense_loss(p, 0.05, 1.5),
     lambda p: jgeo.dense_loss(p, 0.05, 1.5),
     lambda r: [r.random((2, 50, 1)).astype(np.float32) - 0.3]),
    ("edge_uniform", lambda e: geo.edge_uniform_loss(e, 0.05),
     lambda e: jgeo.edge_uniform_loss(e, 0.05),
     lambda r: [_cloud(r, 2, 40, 8, 3)]),
    ("temporal", lambda a, b, c, d: geo.temporal_loss(a, b, c, d),
     lambda a, b, c, d: jgeo.temporal_loss(a, b, c, d),
     lambda r: [_cloud(r, 2, 90, 3) for _ in range(4)]),
    ("free_particle", lambda f, p: geo.free_particle_loss(f, p),
     lambda f, p: jgeo.free_particle_loss(f, p),
     lambda r: [_cloud(r, 2, 40, 3), _cloud(r, 2, 120, 3)]),
]


@pytest.mark.parametrize("name,port,jax_fn,make", LOSSES,
                         ids=[x[0] for x in LOSSES])
def test_geometry_loss_matches_jax(rng, name, port, jax_fn, make):
    tv, jv, tg, jg = _value_and_grad(jax_fn, port, *make(rng))
    assert float(jv) != 0.0 or name == "edge_uniform"
    _close(tv, jv)
    _grad_close(tg, jg)


def test_edge_uniform_loss_counts_only_violating_offsets(rng):
    edge = _cloud(rng, 2, 40, 8, 3) * 0.01
    edge[0, 3, 2] = [0.5, 0.0, 0.0]
    edge[1, 7, 1] = [0.0, -0.4, 0.3]
    _close(geo.edge_uniform_loss(T(edge), 0.05),
           jgeo.edge_uniform_loss(jnp.asarray(edge), 0.05))
    assert float(geo.edge_uniform_loss(T(edge * 0), 0.05)) == 0.0


def test_self_neighbor_sq_distances_match_jax(rng):
    pos = _cloud(rng, 2, 200, 3)
    pos[0, 5] = pos[0, 9]                      # a coincident pair: flagged out
    d2, ok = geo._self_neighbor_sq_distances(T(pos), 8, 0.1)
    jd2, jok = jgeo._self_neighbor_sq_distances(jnp.asarray(pos), 8, 0.1)
    _close(d2, jd2)
    assert np.array_equal(ok.numpy(), np.asarray(jok)) and ok.any()


def test_density_matches_jax(rng):
    """The per-particle density (an evaluation quantity, taken without
    gradient: its self pair's distance is f32 noise, 1 / d of it is not)."""
    pos = _cloud(rng, 400, 3)
    got = geo.density(T(pos), 0.03)
    assert got.shape == (400, 1)
    _close(got, jgeo.density(jnp.asarray(pos), 0.03))


def test_earth_mover_distance_loss_matches_jax(rng):
    pred, target = _cloud(rng, 2, 64, 3), _cloud(rng, 2, 64, 3) + 0.2
    tv, jv, tg, jg = _value_and_grad(
        lambda p, t: jgeo.earth_mover_distance_loss(p, t).sum(),
        lambda p, t: geo.earth_mover_distance_loss(p, t).sum(), pred, target)
    _close(tv, jv)
    _grad_close(tg, jg)
    one = geo.earth_mover_distance_loss(T(pred[0]), T(target[0]))
    assert one.shape == () and np.isclose(float(one), float(
        jgeo.earth_mover_distance_loss(jnp.asarray(pred[0]),
                                       jnp.asarray(target[0]))), rtol=RTOL)


# ---------------------------------------------------------------- graphs

def test_graph_builders_match_jax(rng):
    x = _cloud(rng, 2, 150, 3)
    valid = rng.random((2, 150)) > 0.1
    for kw in ({}, {"c_valid": valid}):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: T(v) for k, v in kw.items()}
        got = nbr.dilated_knn_graph(T(x), 12, 3, **tkw)
        want = jnbr.dilated_knn_graph(jnp.asarray(x), 12, 3, **jkw)
        assert got.shape == (2, 150, 4)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(nbr.knn_graph(T(x), 9, **tkw).numpy(),
                              np.asarray(jnbr.knn_graph(jnp.asarray(x), 9,
                                                        **jkw)))
        idx, mask = nbr.fixed_radius_graph(T(x), 0.2, 16, **tkw)
        jidx, jmask = jnbr.fixed_radius_graph(jnp.asarray(x), 0.2, 16, **jkw)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        assert np.array_equal(mask.numpy(), np.asarray(jmask))
        assert 0 < int(mask.sum()) < mask.numel()


@pytest.mark.parametrize("kernel", ["exponential_kernel", "linear_kernel"])
def test_sph_weights_match_jax(rng, kernel):
    r = np.abs(_cloud(rng, 3, 200, scale=0.1))
    for cutoff in (0.05, 0.16):
        _close(getattr(interp, kernel)(T(r), cutoff),
               getattr(jinterp, kernel)(jnp.asarray(r), cutoff))


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("spectral_norm", [False, True])
@pytest.mark.parametrize("activation_first", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_mlp_head_matches_flax(rng, spectral_norm, activation_first, train):
    x = rng.standard_normal((3, 7, 10)).astype(np.float32)
    fm = JMLP(5, hidden_dim=16, hidden_layers=3, activation_first=
              activation_first, spectral_norm=spectral_norm)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    tm = MLP(10, 5, hidden_dim=16, hidden_layers=3, activation_first=
             activation_first, spectral_norm=spectral_norm, device="cpu")
    assert set(tm.state_dict()) == set(state_dict_from_flax(
        flax.core.unfreeze(variables)))
    compare(fm, variables,
            lambda v, a, **k: (lambda o: (o[0], {"batch_stats": o[1].get(
                "batch_stats", {})}))(fm.apply(v, a, train=train, **k)),
            tm, lambda m, a: m(a, train), [x], train)


@pytest.mark.parametrize("fused_train", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_msg_setconv_matches_flax(rng, train, fused_train):
    """Two scales around one set of centres (FPS over valid points), each
    its own ball query and shared MLP, concatenated; the fused op (the
    pooled-MLP kernels' plain versions) where the JAX package's use_fused
    takes its kernel."""
    b, n = 2, 96
    xyz = _cloud(rng, b, n, 3)
    valid = rng.random((b, n)) > 0.2
    xyz[~valid] = 999.0
    feat = rng.standard_normal((b, n, 4)).astype(np.float32)
    spec = dict(mlps=[[16, 24], [8, 16]], npoint=24, radii=[0.2, 0.4],
                nsamples=[8, 16], mask_dummy=True, fused_train=fused_train)
    fm = JSetConv(act=j_lrelu, **spec)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                        jnp.asarray(feat), jnp.asarray(valid), False)
    tm = SetConv.msg(4, spec.pop("mlps"), spec.pop("npoint"),
                     spec.pop("radii"), spec.pop("nsamples"),
                     act=leaky_relu_001, device="cpu", **spec)
    assert [n for n, _ in tm.named_children()] == ["SharedMLP_0",
                                                   "SharedMLP_1"]
    compare(fm, variables,
            lambda v, x, f, va, **k: _features(fm.apply(v, x, f, va, train,
                                                        **k)),
            tm, lambda m, x, f, va: m(x, f, va, train)[1],
            [xyz, feat, valid], train)


def test_msg_setconv_global_pooling_and_bad_specs(rng):
    xyz = T(_cloud(rng, 2, 40, 3))
    sa = SetConv.msg(0, [[8], [4, 6]], None, [None, None], [None, None],
                     use_xyz=True, spectral_norm=False, act=relu,
                     device="cpu")
    new_xyz, out = sa(xyz, None, train=False)
    assert new_xyz is None and out.shape == (2, 1, 14)
    with pytest.raises(ValueError, match="mlps"):
        SetConv(3, [8], mlps=[[8]], radii=[0.1], nsamples=[4])
    with pytest.raises(ValueError, match="mlps"):
        SetConv(3, mlps=[[8], [8]], radii=[0.1], nsamples=[4, 4])


# ---------------------------------------------------------------- auction

def _optimal(x, y):
    d = ((x[:, None] - y[None]) ** 2).sum(-1)
    r, c = linear_sum_assignment(d)
    return d[r, c].sum()


def _cost(x, y, assign):
    return float(((x - y[assign]) ** 2).sum())


@pytest.mark.parametrize("knobs", [dict(phases=3, theta=6.0, eps=0.01),
                                   dict(phases=3, final_iters=1500, eps=0.01),
                                   dict(phases=1, final_iters=2000, eps=0.05)],
                         ids=["theta", "final_iters", "one phase"])
def test_auction_knobs_stay_within_n_eps_of_the_optimum(rng, knobs):
    eps = knobs["eps"]
    x, y = _cloud(rng, 2, 96, 3), _cloud(rng, 2, 96, 3) + 0.1
    got = metrics.auction_assignment(T(x), T(y), iters=200, **knobs).numpy()
    want = np.asarray(jmetrics.auction_assignment(
        jnp.asarray(x), jnp.asarray(y), iters=200, **knobs))
    for bi in range(2):
        opt = _optimal(x[bi], y[bi])
        for a in (got[bi], want[bi]):
            if knobs["phases"] > 1:
                assert sorted(a) == list(range(96))       # a permutation
            assert _cost(x[bi], y[bi], a) <= opt + 96 * eps + 1e-5


def test_auction_theta_ladder_and_final_iters_are_used(monkeypatch, rng):
    """theta fixes the phase ladder to eps theta^p (phases of it), and
    final_iters caps the final phase's rounds."""
    seen = []
    own = metrics._auction_phase

    def phase(x, y, price, eps, iters, assign0=None):
        seen.append((eps, iters))
        return own(x, y, price, eps, iters, assign0)

    monkeypatch.setattr(metrics, "_auction_phase", phase)
    x, y = T(_cloud(rng, 1, 32, 3)), T(_cloud(rng, 1, 32, 3))
    metrics.auction_assignment(x, y, eps=0.01, iters=7, phases=3, theta=2.0,
                               final_iters=10)
    assert [e for e, _ in seen[:2]] == pytest.approx([0.04, 0.02])
    assert seen[2][0] == pytest.approx(0.01)
    assert sum(i for _, i in seen[2:]) <= 10 and seen[2][1] == 7


def test_auction_splits_large_eps_scaled_batches_per_item(monkeypatch, rng):
    """At N >= 32,768 (the JAX package's threshold) with eps scaling, each
    item is solved alone (its own schedule); shown here at a lowered
    threshold: the batched call equals the items' own calls bit for bit."""
    calls = []
    own = metrics.auction_assignment

    def counted(x, y, *a, **k):
        calls.append(x.shape[0])
        return own(x, y, *a, **k)

    x, y = T(_cloud(rng, 3, 48, 3)), T(_cloud(rng, 3, 48, 3) * 2.0)
    each = [own(x[i:i + 1], y[i:i + 1], eps=1e-3, iters=50, phases=3)
            for i in range(3)]
    monkeypatch.setattr(metrics, "auction_assignment", counted)
    monkeypatch.setattr(metrics, "SPLIT_ITEMS_AT", 48)
    got = metrics.auction_assignment(x, y, eps=1e-3, iters=50, phases=3)
    assert calls == [3, 1, 1, 1]
    assert torch.equal(got, torch.cat(each))
    calls.clear()
    metrics.auction_assignment(x, y, eps=1e-3, iters=50, phases=1)
    assert calls == [3]                      # one phase: one batched solve


# ---------------------------------------------------------------- sampling

def _fluid_block(rng, n=3000):
    return (rng.random((n, 3)) * [1.2, 0.6, 1.2]).astype(np.float32)


def test_voxel_downsample_matches_jax(rng):
    pos = _fluid_block(rng)
    feat = rng.standard_normal((pos.shape[0], 5)).astype(np.float32)
    for ratio in (0.5, 0.25):
        got = sampling.voxel_downsample(pos, 0.025, ratio,
                                        np.random.default_rng(3))
        want = jsampling.voxel_downsample(pos, 0.025, ratio,
                                          np.random.default_rng(3))
        assert got.shape[0] > 0 and np.array_equal(got, want)
        gp, gf = sampling.voxel_downsample_with_feat(
            pos, feat, 0.025, ratio, np.random.default_rng(4))
        wp, wf = jsampling.voxel_downsample_with_feat(
            pos, feat, 0.025, ratio, np.random.default_rng(4))
        assert np.array_equal(gp, wp) and np.array_equal(gf, wf)


def test_sample_patch_and_overlap_filter_match_jax(rng):
    pos = _fluid_block(rng, 12000)
    for surface in (True, False):
        got = sampling.sample_patch(pos, 1.0, surface,
                                    np.random.default_rng(5))
        want = jsampling.sample_patch(pos, 1.0, surface,
                                      np.random.default_rng(5))
        assert len(got) == len(want) == (3 if surface else 2)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    assert got[0].shape == (8192, 3)
    dup = np.concatenate([pos[:500], pos[:500] + 1e-4])
    merged = sampling.filter_overlap_particles(dup)
    assert np.array_equal(merged, jsampling.filter_overlap_particles(dup))
    assert merged.shape[0] < dup.shape[0]
    for a, b in zip(sampling.get_distribution_info(pos),
                    jsampling.get_distribution_info(pos)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------- training

def test_param_count_matches_jax_and_the_cli_prints_it():
    jcfg = JFluidTrainConfig(batch_size=2, patch_size=128, node_embedding=32)
    _, _, jstate = jax_init_fluid_state(jcfg, jax.random.PRNGKey(0))
    state = init_fluid_state(port_config(jcfg), 0, "cpu")
    for name in ("sr", "tempo", "spatial"):
        assert param_count(getattr(state, name).module) == jax_param_count(
            getattr(jstate, name).params)
    lines = []
    print_network_sizes(state, lines.append)
    assert lines[1:] == [
        f"Total trainable parameters ({n}): {jax_param_count(p.params)}"
        for n, p in (("sr_net", jstate.sr), ("tempo_dis", jstate.tempo),
                     ("spatial_dis", jstate.spatial))]


def test_step_helpers_match_jax(rng):
    key = jax.random.PRNGKey(4)
    angles = np.asarray(jax.random.uniform(key, (3,)) * 2 * jnp.pi)
    _close(step.rotation_matrix(T(angles)), jstep.get_rotation_matrix(key),
           atol=1e-6)
    gen = torch.Generator().manual_seed(2)
    r = step.get_rotation_matrix(gen)
    _close(r @ r.t(), np.eye(3), atol=1e-6)
    assert np.isclose(float(torch.linalg.det(r)), 1.0, atol=1e-6)
    pos, vel = _cloud(rng, 3, 2, 50, 3), _cloud(rng, 3, 2, 50, 3)
    for sign in (1, -1):
        _close(step.advect_particle(T(pos), T(vel), sign),
               jstep.advect_particle(jnp.asarray(pos), jnp.asarray(vel), sign))
    # rotate_lst: a rotation a frame from the generator, the same for the
    # velocities; the JAX package's from the same angles
    got_p, got_v = step.rotate_lst(torch.Generator().manual_seed(9), T(pos),
                                   T(vel))
    ang = step.random_angles(torch.Generator().manual_seed(9), 3)
    rots = step.rotation_matrix(ang)
    assert torch.equal(got_p, step.rotate_frames(T(pos), rots))
    assert torch.equal(got_v, step.rotate_frames(T(vel), rots))
    jkey = jax.random.PRNGKey(6)
    jrot = jstep.rotate_lst(jkey, jnp.asarray(pos))
    jang = np.stack([np.asarray(jax.random.uniform(k, (3,)) * 2 * jnp.pi)
                     for k in jax.random.split(jkey, 3)])
    _close(step.rotate_frames(T(pos), step.rotation_matrix(T(jang))), jrot,
           atol=1e-6)
    assert torch.equal(step.rotate_lst(torch.Generator().manual_seed(9),
                                       T(pos)), got_p)
