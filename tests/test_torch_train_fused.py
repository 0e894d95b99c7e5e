"""One fluid GAN train step of the PyTorch port with every generator EdgeConv
trained through the fused kernels (``SRNet(fused_train=True)``) against the
JAX package's step with ``_TRAIN_FUSED`` patched on (its
``TPUGAN_FUSED_EDGECONV_TRAIN=1``), by norm from a shared state: the
harness of ``tests/test_torch_train_step.py`` (its limits and their
reasons) on one iteration. The switch changes the generator's update only,
so its test runs an odd iteration (the generator's update, with the
adversarial losses through both critics); ``one_iteration`` runs any
configuration that way, and an even iteration where the critics update too
(``tests/test_torch_train_branches.py``, ``tests/test_torch_train_capped.py``). At these toy widths the JAX
package's own fused and grouped steps differ by 5-8 % in most generator
gradients from one state, so the critics' update on top of that is left to
the grouped harness.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpugan_tpu.nn.edgeconv as jax_edgeconv_mod
from test_torch_train_step import (CFG, assert_net_close, draws_from_key,
                                   port_config, step_keys, with_adam_state)
from tpugan_tpu.train import init_fluid_state, make_fluid_gan_step
from tpugan_tpu.train.checkpoint import save_checkpoint
from tpugan_tpu_torch.checkpoint import _tree_to_torch, load_trainer_state
from tpugan_tpu_torch.train.step import FluidGanStep


def one_iteration(cfg, rng, tmp_path, monkeypatch, fused_train=False,
                  even=True):
    """Both steps from one JAX state (written, and carried into the port by
    the trainer-state bridge) on one batch and one key, iteration 102
    (even) or 101; returns the two metric dicts after holding every network
    to ``assert_net_close``. Without device sampling the batch carries the
    loader's lowres inputs."""
    start = 101 if even else 100
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    pcfg = port_config(cfg)
    models, txs, jstate = init_fluid_state(cfg, jax.random.PRNGKey(0))
    jstate = with_adam_state(jstate, start)
    jstep = make_fluid_gan_step(models, txs, cfg)
    m, b, n = (cfg.lowres_size * cfg.upsample_ratio, cfg.batch_size,
               cfg.lowres_size)
    batch_np = {"highres_pos": (rng.standard_normal((3, b, m, 3)) * 0.3)
                .astype(np.float32),
                "highres_vel": rng.standard_normal((3, b, m, 3))
                .astype(np.float32)}
    if not cfg.device_sampling:
        pick = rng.permutation(m)[:n]
        batch_np["lowres_pos"] = (batch_np["highres_pos"][:, :, pick] + 0.003
                                  * rng.standard_normal((3, b, n, 3))
                                  ).astype(np.float32)
        batch_np["lowres_vel"] = batch_np["highres_vel"][:, :, pick]
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    key = step_keys()[int(even)]

    path = str(tmp_path / "state.ckpt")
    save_checkpoint(jstate, path)
    state = load_trainer_state(path, pcfg, device="cpu",
                               fused_train=fused_train)
    nets = ("sr", "tempo", "spatial")
    before = {n: ({k: p.detach().clone() for k, p in
                   getattr(state, n).module.named_parameters()},
                  _tree_to_torch(flax.core.unfreeze(getattr(jstate, n).params),
                                 "params"))
              for n in nets}
    widths = state.spatial.module.fc.dropout_widths()
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch_np.items()},
                       key)
    got = FluidGanStep(pcfg)(state, batch, draws_from_key(key, cfg, m, widths))
    assert got["gate"] and state.n_iter == int(jstate.n_iter) == start + 1
    for k, v in jm.items():
        np.testing.assert_allclose(got[k], float(v), rtol=3e-2, atol=1e-5,
                                   err_msg=k)
    for n in nets:
        assert_net_close(getattr(state, n), getattr(jstate, n), before[n], n)
    return got, jm


def test_fused_train_step_matches_jax(rng, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_edgeconv_mod, "_TRAIN_FUSED", True)
    got, _ = one_iteration(CFG, rng, tmp_path, monkeypatch, fused_train=True,
                           even=False)
    assert got["tempo_G_loss"] != 0.0 and got["spatial_G_loss"] != 0.0
