"""The stacked-critic train path (``--fast_d``) of the PyTorch port against
the JAX package's, on the CPU at tiny widths.

* The port's ``BatchNorm`` under ``stat_groups(G)`` against the JAX
  package's ``GroupedBatchNorm`` and against G sequential flax
  ``nn.BatchNorm`` calls, G = 1, 2, 3 and 6: outputs and running moments
  to 1e-6 of their scale (f32 summation order: the port reduces the [G,
  B/G, ...] view, flax each block), and bit for bit against G sequential
  calls of the port's own ``BatchNorm`` where one block holds the whole
  batch (G = 1); a leading axis that does not divide raises.
* The fluid temporal critic (spectral norm off, 4 items): the port's
  stacked apply against its per-frame loop and against the JAX
  ``stack_frames=True`` apply, the weights carried across by the
  checkpoint bridge: scores and every batch statistic to 1e-4 of their
  scale.
* The action tower's fake/real stacking under ``stat_groups(2)`` against
  two sequential applies: the features to 1e-4 of their scale, the running
  moments against the JAX stacked apply's (frame-major block order) to
  1e-4, and against the sequential order's to the JAX test's 5e-3.
* The fluid spatial critic's stacked update under ``stat_groups(2)``:
  no stage reaches ``pooled_mlp_bn_train`` (counted), the plain stack's
  scores (to 5e-4, the spatial critic's tolerance in
  ``tests/test_torch_discriminator.py``) and running moments (1e-4)
  against the two sequential calls (the fused path's plain versions) and
  against the JAX stacked apply, spectral norm frozen;
  ``SharedMLP.pooled`` raising under G > 1; ``SetConv`` with an all-ones
  valid mask equal to ``valid=None``.
* Both fast-d steps against ``make_fluid_gan_step`` /
  ``make_action_gan_step`` with ``fast_d``, an odd and an even iteration,
  with the draws rebuilt from the JAX step keys, the trainer-state bridge
  and the tolerances of ``tests/test_torch_train_step.py`` and
  ``tests/test_torch_action_train.py`` (dropout off on both sides); the
  bucket-mismatch ``ValueError``.
* The same four steps on two gloo ranks (``data_parallel=True``, each
  rank on 2 of the 4 items, one ``torchrun`` launch) against the same JAX
  steps on the global batch (a data-parallel step is the global batch's
  step), to the same tolerances, both ranks bit for bit.

One JAX step is compiled per workload, in module-scope fixtures: the
fluid one from the JAX init that tests/test_torch_train_step.py uses (at 4
items), the action one from the port's initial weights carried over in the
checkpoint payload.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpugan_tpu_torch.nn.layers as layers
from test_torch_action_train import NETS, _params, jax_state
from test_torch_action_train import draws_from_key as action_draws_from_key
from test_torch_action_train import port_config as action_port_config
from test_torch_train_step import assert_net_close
from test_torch_train_step import draws_from_key as fluid_draws_from_key
from test_torch_train_step import port_config as fluid_port_config
from test_torch_train_step import step_keys, with_adam_state
from test_train_step import TINY_ACTION, TINY_FLUID
import torch_threads  # noqa: F401  (the cores among xdist workers)
from torch_dist_worker import run_ranks
from tpugan_tpu.config import replace
from tpugan_tpu.models.discriminator import FluidSpatialDis as JSpatial
from tpugan_tpu.models.discriminator import FluidTempoDis as JTempo
from tpugan_tpu.models.discriminator import _ActionTempoTower as JTower
from tpugan_tpu.nn.layers import GroupedBatchNorm
from tpugan_tpu.nn.layers import stat_groups as j_stat_groups
from tpugan_tpu.train import init_fluid_state as jax_init_fluid_state
from tpugan_tpu.train import make_action_gan_step, make_fluid_gan_step
from tpugan_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from tpugan_tpu.train.step import _make_optimizers, build_action_models
from tpugan_tpu_torch.checkpoint import (_tree_to_torch,
                                         load_action_trainer_state,
                                         load_trainer_state)
from tpugan_tpu_torch.models.discriminator import (ActionTempoTower,
                                                   FluidSpatialDis,
                                                   FluidTempoDis)
from tpugan_tpu_torch.nn.layers import (BatchNorm, SharedMLP, SpectralNorm,
                                        stat_groups)
from tpugan_tpu_torch.nn.setconv import SetConv
from tpugan_tpu_torch.train.checkpoint import flax_variables, trainer_payload
from tpugan_tpu_torch.train.state import init_action_state, init_fluid_state
from tpugan_tpu_torch.train.step import (ActionGanStep, FluidGanStep,
                                         FluidTrainConfig, StepDraws)

T = torch.from_numpy
START_ITER = 100


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max(1, max |want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else want
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _stats(variables):
    return _tree_to_torch(flax.core.unfreeze(variables), "batch_stats")


def _bn_stats(module):
    """The BatchNorm running moments of a port module, by state_dict key."""
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith((".mean", ".var"))}


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


@pytest.fixture
def frozen_sn(monkeypatch):
    """Spectral norms that never store their power iteration, so every call
    sees the same normalised weights (stacked and sequential applies
    advance them a different number of times)."""
    own = SpectralNorm.forward
    monkeypatch.setattr(SpectralNorm, "forward",
                        lambda self, w, update_stats: own(self, w, False))


# ---------------------------------------------------------- grouped BN

@pytest.mark.parametrize("groups", [1, 2, 3, 6])
def test_grouped_batch_norm_matches_flax(groups):
    rng = np.random.default_rng(groups)
    b, n, c = 4, 17, 8
    x = rng.standard_normal((groups * b, n, c)).astype(np.float32) * 2 + 0.5
    scale, bias = (rng.standard_normal(c).astype(np.float32) for _ in "sb")
    mean = rng.standard_normal(c).astype(np.float32)
    var = np.abs(rng.standard_normal(c)).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean),
                                 "var": jnp.asarray(var)}}

    def port_bn():
        bn = BatchNorm(c, device="cpu")
        with torch.no_grad():
            for name, v in (("scale", scale), ("bias", bias), ("mean", mean),
                            ("var", var)):
                getattr(bn, name).copy_(T(v))
        return bn

    bn = port_bn()
    with stat_groups(groups):
        got = bn(T(x), train=True)
    assert layers.current_stat_groups() == 1

    # the JAX package's GroupedBatchNorm
    want, upd = GroupedBatchNorm(groups=groups).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    _close(got, want, 1e-6, "GroupedBatchNorm output")
    for k in ("mean", "var"):
        _close(getattr(bn, k), upd["batch_stats"][k], 1e-6, k)

    # G sequential flax BatchNorm calls, and G sequential calls of the port's
    ref = fnn.BatchNorm(use_running_average=False, axis_name=None)
    stats, outs = variables["batch_stats"], []
    seq = port_bn()
    seq_outs = []
    for i in range(groups):
        blk = x[i * b:(i + 1) * b]
        y, u = ref.apply({"params": variables["params"], "batch_stats": stats},
                         jnp.asarray(blk), mutable=["batch_stats"])
        outs.append(np.asarray(y))
        stats = u["batch_stats"]
        seq_outs.append(seq(T(blk), train=True))
    _close(got, np.concatenate(outs), 1e-6, "sequential flax output")
    for k in ("mean", "var"):
        _close(getattr(bn, k), stats[k], 1e-6, k)
    seq_out = torch.cat(seq_outs)
    if groups == 1:      # the same code path: bit for bit
        assert torch.equal(got, seq_out)
        for k in ("mean", "var"):
            assert torch.equal(getattr(bn, k), getattr(seq, k))
    else:
        _close(got, seq_out, 1e-6, "sequential port output")
        for k in ("mean", "var"):
            _close(getattr(bn, k), getattr(seq, k), 1e-6, k)

    # eval mode ignores the groups: the running moments
    with stat_groups(groups), torch.no_grad():
        ev = bn(T(x), train=False)
    assert torch.equal(ev, bn(T(x), train=False))


def test_grouped_batch_norm_refuses_uneven_blocks():
    bn = BatchNorm(4, device="cpu")
    with stat_groups(3), pytest.raises(ValueError, match="3 stat groups"):
        bn(torch.ones(4, 5, 4), train=True)
    assert layers.current_stat_groups() == 1


# ---------------------------------------------------------- critics

def _frames(rng, k, b, n, scale):
    return [(rng.standard_normal((b, n, 3)) * scale).astype(np.float32)
            for _ in range(k)]


def test_fluid_tempo_stack_frames(no_dropout):
    """Spectral norm off, dropout off: the port's stacked apply against its
    per-frame loop and against JAX ``stack_frames=True``."""
    rng = np.random.default_rng(0)
    b, n = 4, 96
    pos, vel = _frames(rng, 3, b, n, 0.3), _frames(rng, 3, b, n, 0.1)
    valid = [np.ones((b, n), bool) for _ in range(3)]
    valid[1][:, -7:] = False
    tm = {stack: FluidTempoDis(3, spectral_norm=False,
                               generator=torch.Generator().manual_seed(4),
                               device="cpu") for stack in (False, True)}
    variables = flax_variables(tm[True])
    keep = [torch.ones(b, 256)]
    got = {}
    for stack, mod in tm.items():
        with torch.no_grad():
            got[stack] = mod([T(p) for p in pos], 0.1,
                             feat_lst=[T(v) for v in vel],
                             valid_lst=[T(v) for v in valid], train=True,
                             keep=keep, stack_frames=stack)
    want, upd = jax.jit(lambda v: JTempo(3, spectral_norm=False).apply(
        v, [jnp.asarray(p) for p in pos], 0.1,
        feat_lst=[jnp.asarray(v) for v in vel],
        valid_lst=[jnp.asarray(v) for v in valid], train=True,
        stack_frames=True, mutable=["batch_stats"]))(variables)
    assert got[True].shape == (b, 1)
    _close(got[True], got[False], 1e-4, "stacked vs loop")
    _close(got[True], want, 1e-4, "stacked vs JAX")
    seq, stk = _bn_stats(tm[False]), _bn_stats(tm[True])
    jstats = _stats(upd["batch_stats"])
    assert set(jstats) == set(stk)
    for k, v in jstats.items():
        _close(stk[k], seq[k], 1e-4, k)
        _close(stk[k], v, 1e-4, k)


def test_fluid_tempo_stack_frames_checks_frames():
    mod = FluidTempoDis(3, spectral_norm=False, device="cpu")
    pos = [torch.zeros(2, 32, 3), torch.zeros(2, 32, 3), torch.zeros(2, 16, 3)]
    with pytest.raises(ValueError, match="uniform frame shapes"):
        mod(pos, 0.1, train=True, stack_frames=True)
    pos = [torch.zeros(2, 32, 3)] * 3
    with pytest.raises(ValueError, match="all-or-none"):
        mod(pos, 0.1, valid_lst=[torch.ones(2, 32, dtype=torch.bool), None,
                                 None], train=True, stack_frames=True)


def test_action_tower_fake_real_stacking():
    """Spectral norm off: one apply on [fake; real] under stat_groups(2)
    (with the frames stacked: six blocks in sa1 and sa2) against the
    sequential fake then real applies, and its running moments against the
    JAX stacked apply's (the frame-major block order)."""
    rng = np.random.default_rng(1)
    b, n = 2, 64
    fake, true = _frames(rng, 3, b, n, 1.0), _frames(rng, 3, b, n, 1.0)
    both = [np.concatenate([f, t]) for f, t in zip(fake, true)]
    make = lambda: ActionTempoTower(3, False, [256, 512],
                                    generator=torch.Generator().manual_seed(6),
                                    device="cpu")
    seq, stk = make(), make()
    variables = flax_variables(stk)
    with torch.no_grad():
        f_out = seq([T(p) for p in fake], 2.0, train=True)
        t_out = seq([T(p) for p in true], 2.0, train=True)
        with stat_groups(2):
            s_out = stk([T(p) for p in both], 2.0, train=True,
                        stack_frames=True)

    def jax_stacked(v):
        with j_stat_groups(2):
            return JTower(3, False, (256, 512)).apply(
                v, [jnp.asarray(p) for p in both], 2.0, train=True,
                stack_frames=True, mutable=["batch_stats"])

    want, upd = jax.jit(jax_stacked)(variables)
    _close(s_out[:b], f_out, 1e-4, "fake half")
    _close(s_out[b:], t_out, 1e-4, "real half")
    _close(s_out, want, 1e-4, "stacked vs JAX")
    jstats, got, seq_stats = _stats(upd["batch_stats"]), _bn_stats(stk), \
        _bn_stats(seq)
    assert set(jstats) == set(got)
    for k, v in jstats.items():
        _close(got[k], v, 1e-4, k)
        _close(got[k], seq_stats[k], 5e-3, k)


def test_fluid_spatial_stacked_update(no_dropout, frozen_sn, monkeypatch):
    """The stacked update's apply under stat_groups(2) reaches no pooled-MLP
    batch-norm launch (its stages take the plain stack), and equals the
    two sequential calls, which take the fused path (here its plain
    versions), and the JAX stacked apply."""
    calls = []
    own = layers.pooled_mlp_bn_train

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return own(*a, **kw)

    monkeypatch.setattr(layers, "pooled_mlp_bn_train", counting)
    rng = np.random.default_rng(2)
    b, n = 4, 128
    fake, true = _frames(rng, 2, b, n, 0.3)
    valid = np.ones((b, n), bool)
    valid[:, -20:] = False
    make = lambda: FluidSpatialDis(generator=torch.Generator().manual_seed(8),
                                   device="cpu")
    seq, stk = make(), make()
    variables = flax_variables(stk)
    keep = [torch.ones(b, 256)]
    with torch.no_grad():
        f_out = seq(T(fake), T(valid), train=True, keep=keep)
        t_out = seq(T(true), None, train=True, keep=keep)
        assert len(calls) == 8
        with stat_groups(2):
            s_out = stk(T(np.concatenate([fake, true])),
                        T(np.concatenate([valid, np.ones_like(valid)])),
                        train=True, keep=[torch.ones(2 * b, 256)])
    assert len(calls) == 8, "a stage reached pooled_mlp_bn_train under G = 2"

    def jax_stacked(v):
        with j_stat_groups(2):
            return JSpatial().apply(
                v, jnp.asarray(np.concatenate([fake, true])),
                jnp.asarray(np.concatenate([valid, np.ones_like(valid)])),
                True, mutable=["batch_stats"])

    want, upd = jax.jit(jax_stacked)(variables)
    # the spatial critic's tolerance in tests/test_torch_discriminator.py
    _close(s_out[:b], f_out, 5e-4, "fake half")
    _close(s_out[b:], t_out, 5e-4, "real half")
    _close(s_out, want, 5e-4, "stacked vs JAX")
    got, seq_stats = _bn_stats(stk), _bn_stats(seq)
    jstats = {k: v for k, v in _stats(upd["batch_stats"]).items()
              if k.endswith((".mean", ".var"))}
    assert set(jstats) == set(got)
    for k, v in jstats.items():
        _close(got[k], v, 1e-4, k)
        _close(got[k], seq_stats[k], 1e-4, k)


def test_pooled_refuses_stat_groups():
    mlp = SharedMLP(6, [8, 8], act=layers.leaky_relu_001, norm="batch",
                    use_bias=False, device="cpu")
    x = torch.randn(4, 5, 3, 6)
    mlp.pooled(x, train=True)
    with stat_groups(2), pytest.raises(ValueError, match="stat_groups"):
        mlp.pooled(x, train=True)
    with stat_groups(2), pytest.raises(ValueError, match="stat_groups"):
        mlp.pooled(x, train=False)


def test_setconv_valid_ones_equals_none():
    rng = np.random.default_rng(3)
    b, n = 2, 80
    pos = T(rng.standard_normal((b, n, 3)).astype(np.float32))
    sa = SetConv(3, [16, 32], npoint=24, radius=0.5, nsample=8,
                 mask_dummy=True, spectral_norm=False, device="cpu")
    with torch.no_grad():
        p_none, f_none = sa(pos, pos, valid=None, train=True)
        p_ones, f_ones = sa(pos, pos, valid=torch.ones(b, n, dtype=torch.bool),
                            train=True)
    assert torch.equal(p_none, p_ones) and torch.equal(f_none, f_ones)


# ---------------------------------------------------------- the steps

# 4 items, as the action step's test: at 2 the critics' heads
# batch-normalise over two items, and with fast_d the JAX step's own
# gradients to the generator move past the tolerances under f32 noise
FLUID_CFG = replace(TINY_FLUID, batch_size=4, use_vel=True, in_node_feats=6,
                    device_sampling=True, ml_gate=1e9, fast_d=True)
ACTION_CFG = replace(TINY_ACTION, batch_size=4, device_sampling=True,
                     fast_d=True)


def _with_adam(state):
    """Adam from count START_ITER with mu 0 and nu 1 (see
    tests/test_torch_train_step.py)."""
    state.n_iter = START_ITER
    for net in (state.sr, state.tempo, state.spatial):
        net.opt.count = net.opt.sched_count = START_ITER
        net.opt.nu = {k: torch.ones_like(v) for k, v in net.opt.nu.items()}
    return state


def _jax_run(step, jstate, batch, keys, root):
    """The JAX step over ``keys`` from ``jstate``, dropout off: per
    iteration the checkpoint it started from, its key, the params before,
    the JAX state and metrics after."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    out = []
    try:
        for key in keys:
            path = str(root / f"state_{int(jstate.n_iter)}.ckpt")
            jax_save_checkpoint(jstate, path)
            before = {n: _params(getattr(jstate, n)) for n in NETS}
            jstate, jm = step(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, key)
            out.append(dict(path=path, key=key, before=before,
                            after=jax.device_get(jstate),
                            metrics={k: float(v) for k, v in jm.items()}))
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def fluid_run(tmp_path_factory):
    """The JAX state and batch as tests/test_torch_train_step.py makes them
    (its JAX init at key 0, Adam from count START_ITER, the batch of
    ``default_rng(0)``), at 4 items."""
    models, txs, jstate = jax_init_fluid_state(FLUID_CFG,
                                               jax.random.PRNGKey(0))
    step = make_fluid_gan_step(models, txs, FLUID_CFG)
    b, m = FLUID_CFG.batch_size, FLUID_CFG.patch_size
    rng = np.random.default_rng(0)
    batch = {"highres_pos": (rng.standard_normal((3, b, m, 3)) * 0.3)
             .astype(np.float32),
             "highres_vel": rng.standard_normal((3, b, m, 3))
             .astype(np.float32)}
    its = _jax_run(step, with_adam_state(jstate, START_ITER), batch,
                   step_keys(), tmp_path_factory.mktemp("fluid_fast_d"))
    return dict(batch=batch, iterations=its)


@pytest.fixture(scope="module")
def action_run(tmp_path_factory):
    state = _with_adam(init_action_state(action_port_config(ACTION_CFG), 0,
                                         "cpu"))
    step = make_action_gan_step(build_action_models(ACTION_CFG),
                                _make_optimizers(ACTION_CFG), ACTION_CFG)
    f, b, m = (ACTION_CFG.frames_per_clip, ACTION_CFG.batch_size,
               ACTION_CFG.num_points)
    rng = np.random.default_rng(7)
    batch = {"highres_pos": (rng.standard_normal((f, b, m, 3)) * 0.3)
             .astype(np.float32)}
    its = _jax_run(step, jax_state(trainer_payload(state)), batch,
                   jax.random.split(jax.random.PRNGKey(11), 2),
                   tmp_path_factory.mktemp("action_fast_d"))
    return dict(batch=batch, iterations=its)


def _stacked_ones(draws, b, widths):
    for c in StepDraws.STACKED:
        draws.keep[c] = [torch.ones(2 * b, w) for w in widths]
    return draws


def _hold(state, it, got, iteration):
    assert set(got) - {"gate"} == set(it["metrics"])
    assert (got["tempo_D_loss"] != 0.0) == (iteration == "even")
    assert (got["spatial_D_loss"] != 0.0) == (iteration == "even")
    for k, v in it["metrics"].items():
        np.testing.assert_allclose(got[k], v, rtol=3e-2, atol=1e-5, err_msg=k)
    assert state.n_iter == int(it["after"].n_iter)


def _before(state, it):
    return {n: ({k: p.detach().clone() for k, p in
                 getattr(state, n).module.named_parameters()},
                it["before"][n]) for n in NETS}


def _fluid_case(fluid_run, it):
    """The port's fast-d fluid config, the state of the JAX checkpoint
    ``it["path"]``, the draws of its key (dropout off) and the batch."""
    pcfg = fluid_port_config(FLUID_CFG)
    state = load_trainer_state(it["path"], pcfg, device="cpu")
    widths = state.spatial.module.fc.dropout_widths()
    draws = _stacked_ones(fluid_draws_from_key(
        it["key"], FLUID_CFG, FLUID_CFG.patch_size, widths),
        FLUID_CFG.batch_size, widths)
    batch = {k: T(v) for k, v in fluid_run["batch"].items()}
    return pcfg, state, draws, batch


def _action_case(action_run, it):
    """The same for the action workload."""
    pcfg = action_port_config(ACTION_CFG)
    state = load_action_trainer_state(it["path"], pcfg, device="cpu")
    draws = _stacked_ones(action_draws_from_key(
        it["key"], ACTION_CFG, ACTION_CFG.num_points),
        ACTION_CFG.batch_size, (256, 64))
    batch = {"highres_pos": T(action_run["batch"]["highres_pos"])}
    return pcfg, state, draws, batch


@pytest.mark.parametrize("iteration", ["odd", "even"])
def test_fluid_fast_d_step_matches_jax(fluid_run, iteration):
    it = fluid_run["iterations"][["odd", "even"].index(iteration)]
    pcfg, state, draws, batch = _fluid_case(fluid_run, it)
    assert pcfg.fast_d
    before = _before(state, it)
    got = FluidGanStep(pcfg)(state, batch, draws)
    assert got["gate"]
    _hold(state, it, got, iteration)
    for n in NETS:
        assert_net_close(getattr(state, n), getattr(it["after"], n), before[n],
                         n)


@pytest.mark.parametrize("iteration", ["odd", "even"])
def test_action_fast_d_step_matches_jax(action_run, iteration):
    it = action_run["iterations"][["odd", "even"].index(iteration)]
    pcfg, state, draws, batch = _action_case(action_run, it)
    assert pcfg.fast_d
    before = _before(state, it)
    got = ActionGanStep(pcfg)(state, batch, draws)
    _hold(state, it, got, iteration)
    for n in NETS:
        assert_net_close(getattr(state, n), getattr(it["after"], n), before[n],
                         n)


@pytest.fixture(scope="module")
def dp_run(fluid_run, action_run, tmp_path_factory):
    """Both fast-d steps of each workload, each from its JAX state, on two
    gloo ranks (``tests/torch_dist_worker.py``, one launch), each rank on
    its 2 of the 4 items: the data-parallel step (``data_parallel=True``:
    the stacked halves' batch norms pool their moments across the ranks,
    the gradients are averaged), which must equal the global batch's
    step the fixtures run."""
    runs = {}
    for name, run, case in (("fluid", fluid_run, _fluid_case),
                            ("action", action_run, _action_case)):
        runs[name] = []
        for it in run["iterations"]:
            pcfg, state, draws, batch = case(run, it)
            runs[name].append(dict(state=state, cfg=pcfg, batch=batch,
                                   draws=draws))
    outs = run_ranks("steps", {n: {"runs": r} for n, r in runs.items()},
                     tmp_path_factory.mktemp("fast_d_dp"))
    return runs, outs


@pytest.mark.parametrize("workload", ["fluid", "action"])
def test_fast_d_data_parallel_step_matches_jax(fluid_run, action_run, dp_run,
                                                workload):
    """Each rank's state after the 2-rank step against the JAX step's, an
    odd and an even iteration, to the single-process tolerances; both
    ranks bit for bit."""
    runs, outs = dp_run
    jax_run = fluid_run if workload == "fluid" else action_run
    for i, iteration in enumerate(("odd", "even")):
        it = jax_run["iterations"][i]
        a, b = (o[workload][i]["dp"] for o in outs)
        assert a["metrics"] == b["metrics"]
        for n in NETS:
            for part in ("sd", "mu", "nu"):
                for k, v in a["state"][n][part].items():
                    assert torch.equal(v, b["state"][n][part][k]), (n, k)
        state = runs[workload][i]["state"]
        before = _before(state, it)
        for n in NETS:
            net = getattr(state, n)
            net.module.load_state_dict(a["state"][n]["sd"])
            net.opt.mu, net.opt.nu = a["state"][n]["mu"], a["state"][n]["nu"]
            net.opt.count = a["state"][n]["count"]
        state.n_iter = a["state"]["n_iter"]
        _hold(state, it, a["metrics"], iteration)
        for n in NETS:
            assert_net_close(getattr(state, n), getattr(it["after"], n),
                             before[n], n)


def test_fluid_fast_d_refuses_bucket_mismatch():
    """fps_ratio * upsample_ratio != 1: the padded prediction bucket (64)
    differs from the high-res point count (128)."""
    cfg = FluidTrainConfig(batch_size=2, patch_size=128, upsample_ratio=4,
                           node_embedding=32, fast_d=True)
    state = init_fluid_state(cfg, 0, "cpu")
    batch = {"highres_pos": torch.zeros(3, 2, 128, 3),
             "highres_vel": torch.zeros(3, 2, 128, 3)}
    with pytest.raises(ValueError, match="prediction bucket"):
        FluidGanStep(cfg)(state, batch)
