"""Data-parallel train steps of the port on two gloo ranks on the CPU
against the JAX package's data-parallel step and the port's single-process
step on the global batch.

One ``torchrun`` launch of two ranks (``tests/torch_dist_worker.py``, case
``steps``), each rank on its contiguous rows of a global batch of 4 items
(at 2 items the critics' batch norms are ill-conditioned,
``tests/test_torch_train_step.py``), with the global draws (dropout on:
each rank takes its rows of every multiplier) and Adam from count 100 with
mu 0 and nu 1 (``tests/test_torch_train_step.py`` says why):

* the sequential fluid step (``TINY_FLUID`` widths, ``use_vel``, device
  sampling, the gate held open) and the action step (``TINY_ACTION`` at 4
  clips), sequential and ``fast_d``, each on an even iteration (the
  generator's and both critics' updates): each rank's metrics to
  ``METRIC_RTOL`` and each network's parameter updates, Adam moments and
  running moments by norm to ``TOL`` against the single-process step's
  (f32 noise: the moments' sums and the gradients' averages run in
  another order, and the toy critics' batch norms amplify it; measured
  at most 0.023, 0.043 and 0.024 of a norm, 7.6e-5 of a metric);
* the sequential fluid step, from a JAX state carried over by the
  trainer-state bridge with draws rebuilt from the JAX step key (dropout
  off on both sides), on an even iteration against
  ``make_fluid_gan_step(..., mesh=make_mesh(2))`` (GSPMD's data-parallel
  step on the two-device CPU mesh), to the tolerances of
  ``tests/test_torch_train_step.py``; the JAX step is compiled once;
* two consecutive data-parallel fluid steps (an odd iteration, then an
  even one), the second against the single-process step taken from the
  state the ranks held after the first, on the same global batch and
  draws (the card run's same-state gate, ``chip_smoke.py :
  data_parallel``), by the same measure;
* both ranks bit for bit;
* at two ranks each rank calls the pooled-MLP batch-norm kernel as one
  rank does (12 calls in the fluid G+D step; its plain split here, which
  sums each layer's moment sums over the ranks), with as many collectives
  as the same step on the plain stack, to whose state and metrics it
  holds; the fluid step again in a group of rank 0 alone on the whole
  batch (world size 1) equals the single-process step bit for bit, with
  the same kernel calls;
* the kernel's plain split on each rank's rows against the plain stack
  under ``cross_rank_stats`` (``POOLED_TOL``) and against the whole
  table's single-process op (the moments, each rank's slice of dtable,
  the ranks' dW, dgamma and dbeta summed).

The single-process steps run in the ranks (the fluid ones on rank 0, the
action ones on rank 1: the same processes and thread counts as the
data-parallel steps, so bit-for-bit comparisons hold); the test process
only builds the states, batches and draws, and runs the JAX step.

The ``fast_d`` steps of both workloads on two ranks are held to the JAX
package's steps on the global batch in ``tests/test_torch_fast_d.py``,
whose JAX programs that file compiles anyway.
"""

import contextlib
import copy

import flax
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import tpugan_tpu_torch.nn.layers as layers
from test_torch_action_train import port_config as action_port_config
from test_torch_train_step import CFG as FLUID_CFG
from test_torch_train_step import (assert_net_close, draws_from_key,
                                   port_config, step_keys, with_adam_state)
from test_train_step import TINY_ACTION
import torch_threads  # noqa: F401  (the cores among xdist workers)
from torch_dist_worker import start_ranks
from tpugan_tpu.config import replace
from tpugan_tpu.parallel import make_mesh
from tpugan_tpu.train import init_fluid_state as jax_init_fluid_state
from tpugan_tpu.train import make_fluid_gan_step
from tpugan_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from tpugan_tpu_torch.checkpoint import _tree_to_torch, load_trainer_state
from tpugan_tpu_torch.models.discriminator import (dropout_layers,
                                                   dropout_widths)
from tpugan_tpu_torch.nn.layers import (BatchNorm, SharedMLP,
                                        cross_rank_stats, leaky_relu_001,
                                        relu, stat_groups)
from tpugan_tpu_torch.nn.setconv import SetConv
from tpugan_tpu_torch.ops.kernels import pooled_mlp as P
from tpugan_tpu_torch.train.state import init_action_state, init_fluid_state
from tpugan_tpu_torch.train.step import ActionStepDraws, StepDraws

NETS = ("sr", "tempo", "spatial")
# the pooled split against the plain stack and the single-process op, of
# each tensor's largest magnitude (f32 sums in another order)
POOLED_TOL = 1e-5
POOLED_WIDTHS = [16, 24]
START_ITER = 101            # the step is the even iteration 102
CHAIN_ITER = 100            # the chain's steps are iterations 101 and 102
# a rank's step against the single process, by norm (see _assert_close)
TOL = {"sr": 0.05, "tempo": 0.1, "spatial": 0.1}
METRIC_RTOL = 1e-3


def _prepared(state, count):
    """Adam at ``count`` with mu 0 and nu 1, the step at count + 1."""
    for name in NETS:
        opt = getattr(state, name).opt
        opt.count = opt.sched_count = count
        opt.mu = {k: torch.zeros_like(v) for k, v in opt.mu.items()}
        opt.nu = {k: torch.ones_like(v) for k, v in opt.nu.items()}
    state.n_iter = count
    return state


def _assert_same(a, b):
    """Two tensor dumps (``_state_tensors``) bit for bit."""
    assert a["n_iter"] == b["n_iter"]
    for name in NETS:
        for part in ("sd", "mu", "nu"):
            for k, v in a[name][part].items():
                assert torch.equal(v, b[name][part][k]), (name, part, k)
        assert a[name]["count"] == b[name]["count"]


def _assert_close(got, want, before):
    """A rank's dump against the single process's, as
    ``tests/test_torch_train_step.py : assert_net_close`` holds the port to
    JAX: of each kind (the parameters' updates, Adam's mu and nu - 1, the
    running moments) every tensor within ``TOL[net] * ||want|| + 1e-3
    sqrt(n) r``, r the kind's largest RMS (a gradient that is zero in exact
    arithmetic, a Dense bias under a batch norm, is f32 noise on both
    sides); ``before``: the parameters before the step."""
    for name in NETS:
        g, w, b0 = got[name], want[name], before[name]
        kinds = {
            "change": [(k, g["sd"][k] - b0[k], w["sd"][k] - b0[k]) for k in b0],
            "stats": [(k, g["sd"][k], w["sd"][k]) for k in w["sd"]
                      if k not in b0],
            "mu": [(k, g["mu"][k], w["mu"][k]) for k in w["mu"]],
            "nu": [(k, g["nu"][k] - 1, w["nu"][k] - 1) for k in w["nu"]]}
        for kind, pairs in kinds.items():
            if not pairs:
                continue
            r = max(float(b.norm()) / b.numel() ** 0.5 for _, _, b in pairs)
            for k, a, b in pairs:
                err = float((a - b).norm())
                assert err <= (TOL[name] * float(b.norm())
                               + 1e-3 * b.numel() ** 0.5 * r), (name, kind, k,
                                                               err)


JAX_CFG = replace(FLUID_CFG, batch_size=4)


def _jax_fluid_state(root):
    """The JAX fluid state at 4 items (its init at key 0, Adam from count
    START_ITER as ``_prepared``), written for the trainer-state bridge:
    (models, optimisers, state, checkpoint path, params)."""
    models, txs, jstate = jax_init_fluid_state(JAX_CFG, jax.random.PRNGKey(0))
    jstate = with_adam_state(jstate, START_ITER)
    path = str(root / "jax_state.ckpt")
    jax_save_checkpoint(jstate, path)
    params = {n: _tree_to_torch(flax.core.unfreeze(getattr(jstate, n).params),
                                "params") for n in NETS}
    return models, txs, jstate, path, params


def _jax_mesh_step(models, txs, jstate, batch, key):
    """One step of ``make_fluid_gan_step`` on ``make_mesh(2)``, dropout
    off, compiled now; returns a function that runs it: (state after,
    metrics)."""
    step = make_fluid_gan_step(models, txs, JAX_CFG, mesh=make_mesh(2))
    # host inputs: the mesh step's executable takes uncommitted arrays
    args = (jax.device_get(jstate), {k: v.numpy() for k, v in batch.items()},
            np.asarray(key))
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        compiled = step.lower(*args).compile()
    finally:
        mp.undo()

    def run():
        after, jm = compiled(*args)
        return jax.device_get(after), {k: float(v) for k, v in jm.items()}
    return run


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    rng = np.random.default_rng(0)
    cfg = port_config(replace(FLUID_CFG, batch_size=4))   # gate open
    m = cfg.lowres_size * cfg.upsample_ratio
    batch = {k: torch.from_numpy(a.astype(np.float32)) for k, a in (
        ("highres_pos", rng.standard_normal((3, 4, m, 3)) * 0.3),
        ("highres_vel", rng.standard_normal((3, 4, m, 3))))}
    state = _prepared(init_fluid_state(cfg, 0, "cpu"), START_ITER)
    draws = StepDraws.draw(torch.Generator().manual_seed(3), cfg, m,
                           dropout_widths(state.spatial.module))
    fluid = [dict(state=state, cfg=cfg, batch=batch, draws=draws)]
    work = tmp_path_factory.mktemp("dp")
    models, txs, jstate, path, jparams = _jax_fluid_state(work)
    key = step_keys()[1]          # an even iteration that rotates
    state = load_trainer_state(path, cfg, device="cpu")
    fluid.append(dict(state=state, cfg=cfg, batch=batch, references=False,
                      draws=draws_from_key(key, cfg, m,
                                           dropout_widths(state.spatial.module))))
    action = []
    for fast_d in (False, True):
        acfg = action_port_config(replace(TINY_ACTION, batch_size=4,
                                          device_sampling=True,
                                          fast_d=fast_d))
        state = _prepared(init_action_state(acfg, 1, "cpu"), START_ITER)
        f, m = 3, acfg.num_points
        hp = torch.from_numpy((rng.standard_normal((f, 4, m, 3)) * 0.3)
                              .astype(np.float32))
        draws = ActionStepDraws.draw(
            torch.Generator().manual_seed(5), acfg, (f, 4, m),
            dropout_layers(state.spatial.module),
            dropout_layers(state.tempo.module))
        action.append(dict(state=state, cfg=acfg,
                           batch={"highres_pos": hp}, draws=draws))
    chain = dict(cfg=cfg, state=_prepared(init_fluid_state(cfg, 2, "cpu"),
                                          CHAIN_ITER),
                 batches=[batch, {k: torch.from_numpy(
                     (rng.standard_normal((3, 4, m, 3)) * s)
                     .astype(np.float32)) for k, s in (
                         ("highres_pos", 0.3), ("highres_vel", 1.0))}],
                 draws=[StepDraws.draw(torch.Generator().manual_seed(g), cfg,
                                       m, dropout_widths(
                                           fluid[0]["state"].spatial.module))
                        for g in (8, 9)])
    # the ranks run while this process compiles the JAX step; the step runs
    # once they are done (run beside them, it now and then aborted in
    # XLA:CPU's in-process all-gather, at the collective's termination
    # timeout)
    ranks = start_ranks("steps", {"fluid": {"runs": fluid},
                                  "action": {"runs": action},
                                  "pooled": _pooled_case(), "chain": chain,
                                  "references": True}, work / "ranks")
    jax_step = _jax_mesh_step(models, txs, jstate, batch, key)
    outs = ranks()
    after, metrics = jax_step()
    jax_run = dict(before=jparams, after=after, metrics=metrics)
    before = lambda run: {n: {k: p.detach().clone() for k, p in
                              getattr(run["state"], n).module
                              .named_parameters()} for n in NETS}
    return ([before(r) for r in fluid], [before(r) for r in action], outs,
            fluid[1]["state"], jax_run)


def _pooled_case():
    """A batch-norm SharedMLP's weights (gammas of both signs) and a table
    of 4 items with exact max ties, split over the ranks by item."""
    rng = np.random.default_rng(11)
    mlp = SharedMLP(5, POOLED_WIDTHS, act=leaky_relu_001, norm="batch",
                    use_bias=False, generator=torch.Generator().manual_seed(7),
                    device="cpu")
    with torch.no_grad():
        for layer in mlp.children():
            bn = layer.BatchNorm_0
            bn.scale.copy_(1 + 0.2 * torch.from_numpy(
                rng.standard_normal(bn.scale.shape).astype(np.float32)))
            bn.scale[::3] *= -1
            bn.bias.copy_(0.1 * torch.from_numpy(
                rng.standard_normal(bn.bias.shape).astype(np.float32)))
    table = torch.from_numpy(rng.standard_normal((4, 6, 8, 5))
                             .astype(np.float32))
    table[:, :, 1] = table[:, :, 0]
    g = torch.from_numpy(rng.standard_normal((4, 6, POOLED_WIDTHS[-1]))
                         .astype(np.float32))
    return {"table": table, "g": g, "widths": POOLED_WIDTHS, "seed": 7,
            "state_dict": mlp.state_dict()}


def _hold(got, want, before):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    assert got["metrics"]["tempo_D_loss"] != 0        # the critics updated
    _assert_close(got["state"], want["state"], before)


def test_fluid_dp_step_matches_single_process(steps):
    before, _, outs, *_ = steps
    a, b = (o["fluid"][0]["dp"] for o in outs)
    _assert_same(a["state"], b["state"])
    assert a["metrics"] == b["metrics"] and a["metrics"]["gate"]
    _hold(a, outs[0]["fluid"][0]["plain"], before[0])


def test_fluid_dp_step_matches_jax_mesh_step(steps):
    """Both ranks bit for bit; rank 0's state and metrics against the JAX
    step on ``make_mesh(2)``, as ``tests/test_torch_train_step.py`` holds
    the single-process step to the JAX one."""
    _, _, outs, state, jax_run = steps
    a, b = (o["fluid"][1]["dp"] for o in outs)
    _assert_same(a["state"], b["state"])
    assert a["metrics"] == b["metrics"] and a["metrics"]["gate"]
    assert a["metrics"]["tempo_D_loss"] != 0          # the critics updated
    for k, v in jax_run["metrics"].items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=3e-2, atol=1e-5,
                                   err_msg=k)
    before = {n: ({k: p.detach().clone() for k, p in
                   getattr(state, n).module.named_parameters()},
                  jax_run["before"][n]) for n in NETS}
    for n in NETS:
        net = getattr(state, n)
        net.module.load_state_dict(a["state"][n]["sd"])
        net.opt.mu, net.opt.nu = a["state"][n]["mu"], a["state"][n]["nu"]
        net.opt.count = a["state"][n]["count"]
    assert a["state"]["n_iter"] == int(jax_run["after"].n_iter)
    for n in NETS:
        assert_net_close(getattr(state, n), getattr(jax_run["after"], n),
                         before[n], n)


def test_fluid_dp_at_one_rank_is_the_single_process_step(steps):
    """A group of one rank on the whole batch: the single-process step bit
    for bit, with the same pooled-MLP kernel calls (4 forwards in the
    generator's gated spatial-critic pass, 8 in the critics' update)."""
    _, _, outs, *_ = steps
    got, want = outs[0]["fluid"][0]["alone"], outs[0]["fluid"][0]["plain"]
    _assert_same(got["state"], want["state"])
    assert got["metrics"] == want["metrics"]
    assert got["pooled_calls"] == want["pooled_calls"] == 12


def test_dp_at_two_ranks_keeps_the_pooled_kernel_out(steps):
    """(The name is the parent's, whose two-rank steps kept the kernel out.)
    At two ranks each rank calls the pooled-MLP batch-norm kernel as the
    single-process step does, 12 times in the fluid G+D step (the action
    critics take no fused stage), with as many collectives as the same
    data-parallel step with every SetConv on the plain stack, and holds to
    that step's metrics and state as the rank holds to the single
    process."""
    before, _, outs, *_ = steps
    for o in outs:
        assert [x["dp"]["pooled_calls"] for x in o["fluid"]] == [12, 12]
        assert [x["dp"]["pooled_calls"] for x in o["action"]] == [0, 0]
        kernel, stack = o["fluid"][0]["dp"], o["fluid"][0]["dp_plain_stack"]
        assert stack["pooled_calls"] == 0
        assert kernel["collectives"] == stack["collectives"] > 0
        _hold(kernel, stack, before[0])


def test_fluid_dp_step_matches_single_process_from_the_dp_state(steps):
    """The card's same-state gate on the CPU: after a first data-parallel
    step (odd iteration: the generator alone), the second (even: the
    critics too) on both ranks bit for bit, and held by ``_hold`` against
    the single-process step taken from the state the ranks held between
    the two, on the same global batch and draws."""
    _, _, outs, *_ = steps
    a, b = (o["chain"] for o in outs)
    _assert_same(a["mid"], b["mid"])
    _assert_same(a["dp"]["state"], b["dp"]["state"])
    assert a["dp"]["metrics"] == b["dp"]["metrics"]
    assert a["dp"]["metrics"]["gate"] and a["mid"]["n_iter"] == CHAIN_ITER + 1
    names = {n: [k for k, _ in getattr(steps[3], n).module.named_parameters()]
             for n in NETS}
    before = {n: {k: a["mid"][n]["sd"][k] for k in names[n]} for n in NETS}
    _hold(a["dp"], a["plain"], before)


@pytest.mark.parametrize("fast_d", [False, True])
def test_action_dp_step_matches_single_process(steps, fast_d):
    _, before, outs, *_ = steps
    a, b = (o["action"][int(fast_d)]["dp"] for o in outs)
    _assert_same(a["state"], b["state"])
    assert a["metrics"] == b["metrics"]
    _hold(a, outs[1]["action"][int(fast_d)]["plain"], before[int(fast_d)])


def test_draws_rows_take_each_half_of_a_stacked_multiplier():
    """A rank's rows of the draws: per-item tensors cut along their item
    axis, the frame-major action starts per frame, a stacked [2B, w]
    multiplier in each half; the rest shared."""
    cfg = port_config(replace(FLUID_CFG, batch_size=4, fast_d=True))
    d = StepDraws.draw(torch.Generator().manual_seed(0), cfg, 128, [5, 3])
    r = d.rows(1, 2)
    assert torch.equal(r.fps_start, d.fps_start[2:])
    assert torch.equal(r.jitter, d.jitter[:, 2:])
    assert torch.equal(r.rots1, d.rots1[2:]) and r.labels == d.labels
    assert torch.equal(r.sp_perm, d.sp_perm)
    both = d.keep["tempo_both"][0]
    assert torch.equal(r.keep["tempo_both"][0],
                       torch.cat([both[2:4], both[6:8]]))
    assert torch.equal(r.keep["spatial_g"][1], d.keep["spatial_g"][1][2:])
    acfg = action_port_config(replace(TINY_ACTION, batch_size=4))
    a = ActionStepDraws.draw(torch.Generator().manual_seed(0), acfg,
                             (3, 4, 128), [(5, 0.5)], [(3, 0.5)])
    ra = a.rows(0, 2)
    assert a.items() == 4 and ra.items() == 2
    assert torch.equal(ra.fps_start, a.fps_start.reshape(3, 4)[:, :2]
                       .reshape(-1))
    with pytest.raises(ValueError, match="does not divide"):
        a.rows(0, 3)


def test_cross_rank_stats_pool_moments_and_refuse_the_pooled_kernel(
        monkeypatch):
    """(The name is the parent's, whose pooled-MLP kernel refused under
    ``cross_rank_stats``.) Under ``cross_rank_stats`` a train-mode batch
    norm normalises with the reduced moment sums (two ranks holding the
    same rows: the moments of those rows), and so does the pooled-MLP
    kernel's split, to the same pooled output, running moments and
    gradients as the single-process kernel path; a fused SetConv takes the
    kernel there, and the plain stack under stat_groups(2)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 8, generator=gen) * 2 + 0.5
    plain, synced = BatchNorm(8, device="cpu"), BatchNorm(8, device="cpu")
    want = plain(x, train=True)
    with cross_rank_stats(lambda t: t + t, 2):
        got = synced(x, train=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(synced.var, plain.var, rtol=1e-5, atol=1e-6)
    mlp = SharedMLP(6, [8, 8], act=relu, norm="batch", use_bias=False,
                    generator=gen, device="cpu")
    table = torch.randn(2, 3, 4, 6, generator=gen)
    runs = []
    for ctx in (contextlib.nullcontext(), cross_rank_stats(lambda t: t + t, 2)):
        m, x = copy.deepcopy(mlp), table.clone().requires_grad_()
        with ctx:
            y = m.pooled(x, True)
        y.sum().backward()
        runs.append([y, x.grad, *m.state_dict().values(),
                     *[p.grad for p in m.parameters()]])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    calls = []
    monkeypatch.setattr(layers, "pooled_mlp_bn_train",
                        lambda *a, **k: calls.append(k) or
                        P.pooled_mlp_bn_train(*a, **k))
    sa = SetConv(3, [8, 8], npoint=4, radius=0.5, nsample=4,
                 fused_train=True, generator=gen, device="cpu")
    xyz = torch.randn(2, 16, 3, generator=gen)
    with cross_rank_stats(lambda t: t, 1):
        _, pooled = sa(xyz, xyz, train=True)
    assert pooled.shape == (2, 4, 8) and len(calls) == 1
    assert calls[0]["world"] == 1 and calls[0]["reduce"] is not None
    with stat_groups(2):
        sa(torch.cat([xyz, xyz]), torch.cat([xyz, xyz]), train=True)
    assert len(calls) == 1


def test_pooled_split_on_two_ranks_matches_the_plain_stack(steps):
    """Each rank's pooled split (the kernel's plain version summing each
    layer's moment sums over the ranks) against the plain stack + max
    under ``cross_rank_stats`` on its rows: pooled output, running moments,
    dtable, dW, dgamma, dbeta; its moments, each rank's dtable and the
    ranks' summed parameter gradients against the single-process op on
    the whole table."""
    _, _, outs, *_ = steps
    case = _pooled_case()
    mlp = SharedMLP(5, POOLED_WIDTHS, act=leaky_relu_001, norm="batch",
                    use_bias=False, generator=torch.Generator().manual_seed(7),
                    device="cpu")
    mlp.load_state_dict(case["state_dict"])
    x = case["table"].clone().requires_grad_()
    y = mlp.pooled(x, True)
    (y * case["g"]).sum().backward()
    whole = {k: p.grad for k, p in mlp.named_parameters()}
    close = lambda a, b: torch.testing.assert_close(
        a, b, rtol=0, atol=POOLED_TOL * float(b.abs().max()))
    for r, o in enumerate(outs):
        split, stack = o["pooled"]["split"], o["pooled"]["stack"]
        for k in ("pooled", "table_grad"):
            close(split[k], stack[k])
        for k, v in stack["state"].items():
            close(split["state"][k], v)
        for k, v in stack["grads"].items():
            close(split["grads"][k], v)
        close(split["pooled"], y.detach()[2 * r:2 * r + 2])
        close(split["table_grad"], x.grad[2 * r:2 * r + 2])
        for k, v in mlp.state_dict().items():
            close(split["state"][k], v)
        layers_ = list(mlp.children())
        mus, vars_ = o["pooled"]["moments"]
        _, wmus, wvars, *_ = P.pooled_mlp_bn_forward_plain(
            case["table"], [l.weight(False).t().detach() for l in layers_],
            [l.BatchNorm_0.scale.detach() for l in layers_],
            [l.BatchNorm_0.bias.detach() for l in layers_], 0.01)
        for got, want in zip([*mus, *vars_], [*wmus, *wvars]):
            close(got, want)
    for k, v in whole.items():
        close(outs[0]["pooled"]["split"]["grads"][k]
              + outs[1]["pooled"]["split"]["grads"][k], v)
