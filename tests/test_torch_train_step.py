"""One whole fluid GAN train step of the PyTorch port against the JAX
package's ``make_fluid_gan_step``, two iterations: an odd one (generator
update only) and an even one (generator, then both critics).

The JAX trainer state is initialised at ``TINY_FLUID`` with ``use_vel``,
device sampling and the adversarial gate held open, written with the JAX
package's ``save_checkpoint`` and loaded into the port by the trainer-state
bridge. Each iteration's random draws are rebuilt from the JAX step's own
``jax.random.split(key, 17)`` and handed to the port as ``StepDraws``.
Dropout is off on both sides (flax's ``Dropout.__call__`` patched to the
identity, all-ones multipliers for the port): flax's dropout bits cannot be
replayed outside flax.

Both Adam states start from count 100 with ``mu = 0`` and ``nu = 1`` so that
an update is close to linear in its gradient: from a fresh state Adam's
first update is about ``lr * sign(g)``, and the sign of a gradient that is
zero in exact arithmetic (a Dense bias under a batch norm) is f32 noise.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_train_step import TINY_FLUID
from tpugan_tpu.config import replace
from tpugan_tpu.losses.gan import lsgan_labels
from tpugan_tpu.train import init_fluid_state, make_fluid_gan_step
from tpugan_tpu.train.checkpoint import save_checkpoint
from tpugan_tpu.train.step import get_rotation_matrix
from tpugan_tpu_torch.checkpoint import _tree_to_torch, load_trainer_state
from tpugan_tpu_torch.train.step import FluidGanStep, FluidTrainConfig, StepDraws

CFG = replace(TINY_FLUID, use_vel=True, in_node_feats=6, device_sampling=True,
              ml_gate=1e9)
START_ITER = 100
TOL = {"sr": 0.15, "tempo": 0.3, "spatial": 0.3}   # see assert_net_close


def port_config(cfg):
    names = {f for f in FluidTrainConfig.__dataclass_fields__}
    return FluidTrainConfig(**{k: getattr(cfg, k) for k in names})


def draws_from_key(key, cfg, m, keep_widths):
    """The port's StepDraws of one JAX step key (step.py's key schedule)."""
    keys = jax.random.split(key, 17)
    b, n = cfg.batch_size, cfg.lowres_size
    nr = n * cfg.upsample_ratio
    t = lambda a: torch.from_numpy(np.array(a))
    u = lambda k: float(jax.random.uniform(k, ()))
    rots = lambda k, c: t(jax.vmap(get_rotation_matrix)(jax.random.split(k, c)))
    k_start, k_jit = jax.random.split(keys[16])
    ones = {c: [torch.ones(b, w) for w in keep_widths] for c in StepDraws.CALLS}
    return StepDraws(
        labels=tuple(float(x) for x in lsgan_labels(keys[0])),
        sp_perm=t(jax.random.permutation(keys[1], nr)).long(),
        sp_target=float(jax.random.uniform(keys[3], (), minval=0.8, maxval=1.2)),
        p0=t(jax.random.permutation(keys[4], nr)).long(),
        p2=t(jax.random.permutation(keys[5], nr)).long(),
        tp_target=float(jax.random.uniform(keys[7], (), minval=0.8, maxval=1.2)),
        do_rot=u(keys[8]) > 0.7, rots_fake=rots(keys[9], 3),
        rots_true=rots(keys[10], 3), do_rot_s=u(keys[13]) > 0.7,
        rots0=rots(keys[14], b), rots1=rots(keys[15], b),
        fps_start=t(jax.random.randint(k_start, (b,), 0, m, dtype=jnp.int32)),
        jitter=t(jax.random.normal(k_jit, (3, b, n, 3))), keep=ones)


def step_keys():
    """Keys of the two iterations; the even one rotates in both critic
    updates, so the rotation paths run."""
    for seed in range(1000):
        k_odd, k_even = jax.random.split(jax.random.PRNGKey(seed))
        ks = jax.random.split(k_even, 17)
        if (jax.random.uniform(ks[8], ()) > 0.7
                and jax.random.uniform(ks[13], ()) > 0.7):
            return k_odd, k_even
    raise AssertionError("no key rotates")


def with_adam_state(state, count):
    def fill(opt_state):
        adam, sched = opt_state
        ones = jax.tree_util.tree_map(jnp.ones_like, adam.nu)
        return (adam._replace(count=jnp.asarray(count, jnp.int32), nu=ones),
                sched._replace(count=jnp.asarray(count, jnp.int32)))

    nets = {name: getattr(state, name).replace(
        opt_state=fill(getattr(state, name).opt_state))
        for name in ("sr", "tempo", "spatial")}
    return state.replace(n_iter=jnp.asarray(count, jnp.int32), **nets)


def assert_net_close(net, jnet, before, what):
    """Params, batch_stats and Adam moments of one network; ``before``
    holds both sides' params before the step.

    The step's change of each parameter and mu = 0.1 g (Adam's first
    moment) and nu's change from its initial 1 are held to ``TOL[what]`` of
    the tensor's norm; batch_stats to 1e-4 of the tensor's largest value (at
    least 1: running moments, f32 summation order). The gradients at these toy
    widths are ill-conditioned: a leaky-ReLU pre-activation within f32
    noise of 0 takes the other slope, the critics' heads normalise over 2
    items, and the JAX step's own generator update moves by 5 % of its norm
    (10 % of its largest element) when the input velocities change by 1e-6
    of their value. The critics are worse: their heads' batch norm over 2
    items turns f32 noise into percent (at B=2 the JAX package's own fused
    and XLA spatial critics differ by 2 % in their scores, at B=4 by
    2.4e-4). A wiring fault (a lost or doubled gradient path, a wrong sign,
    a missed state update) moves them by order 1."""
    params = _tree_to_torch(flax.core.unfreeze(jnet.params), "params")
    stats = _tree_to_torch(flax.core.unfreeze(jnet.batch_stats), "batch_stats")
    sd = net.module.state_dict()
    assert set(params) | set(stats) == set(sd), what

    def close(got, want, tol, name, floor=1.0):
        want = want.numpy()
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=tol * max(floor, np.abs(want).max()),
                                   err_msg=f"{what} {name}")

    pairs = {"change": [], "mu": [], "nu": []}

    def norm_close(kind):
        """||got - want|| <= TOL ||want|| + 1e-3 sqrt(n) r, with r the
        largest RMS of a tensor of this kind: a gradient that is zero in
        exact arithmetic (a Dense bias under a batch norm) is f32 noise on
        both sides."""
        r = max(float(w.norm()) / w.numel() ** 0.5 for _, _, w in pairs[kind])
        for name, got, want in pairs[kind]:
            err = float((got - want).norm())
            assert err <= TOL[what] * float(want.norm()) + 1e-3 * want.numel() ** 0.5 * r, (
                f"{what} {kind} {name}: {err} vs norm {float(want.norm())}")

    t_old, j_old = before
    for k, v in params.items():
        pairs["change"].append((k, sd[k] - t_old[k], v - j_old[k]))
    for k, v in stats.items():
        close(sd[k], v, 1e-4, k)
    adam = jnet.opt_state[0]
    assert net.opt.count == int(adam.count)
    for k, v in _tree_to_torch(flax.core.unfreeze(adam.mu), "params").items():
        pairs["mu"].append((k, net.opt.mu[k], v))
    for k, v in _tree_to_torch(flax.core.unfreeze(adam.nu), "params").items():
        pairs["nu"].append((k, net.opt.nu[k] - 1.0, v - 1.0))
    for kind in pairs:
        norm_close(kind)


def test_fluid_gan_step_matches_jax(rng, tmp_path, monkeypatch):
    """Each iteration starts both sides from the same state: the JAX state,
    written and carried into the port by the trainer-state bridge. (Chained,
    the second iteration would compare two chaotic trajectories: the JAX
    step's own losses move by 2-6 % on its second iteration when the input
    velocities change by 1e-6 of their value.)"""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg, pcfg = CFG, port_config(CFG)
    models, txs, jstate = init_fluid_state(cfg, jax.random.PRNGKey(0))
    jstate = with_adam_state(jstate, START_ITER)
    jstep = make_fluid_gan_step(models, txs, cfg)
    step = FluidGanStep(pcfg)
    m = cfg.lowres_size * cfg.upsample_ratio
    b = cfg.batch_size
    batch_np = {"highres_pos": (rng.standard_normal((3, b, m, 3)) * 0.3)
                .astype(np.float32),
                "highres_vel": rng.standard_normal((3, b, m, 3))
                .astype(np.float32)}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    nets = ("sr", "tempo", "spatial")
    for key in step_keys():
        path = str(tmp_path / f"state_{int(jstate.n_iter)}.ckpt")
        save_checkpoint(jstate, path)
        state = load_trainer_state(path, pcfg, device="cpu")
        assert state.n_iter == int(jstate.n_iter)
        before = {n: ({k: p.detach().clone() for k, p in
                       getattr(state, n).module.named_parameters()},
                      _tree_to_torch(flax.core.unfreeze(getattr(jstate, n)
                                                        .params), "params"))
                  for n in nets}
        widths = state.spatial.module.fc.dropout_widths()
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch_np.items()}, key)
        got = step(state, batch, draws_from_key(key, cfg, m, widths))
        assert got["gate"]
        assert (got["tempo_D_loss"] != 0.0) == (state.n_iter % 2 == 0)
        # the critics' scores carry the conditioning of assert_net_close:
        # a batch norm over 2 items in their heads
        for k, v in jm.items():
            np.testing.assert_allclose(got[k], float(v), rtol=3e-2, atol=1e-5,
                                       err_msg=k)
        assert state.n_iter == int(jstate.n_iter)
        for n in nets:
            assert_net_close(getattr(state, n), getattr(jstate, n), before[n], n)
