"""The ``train_novel`` branches of the train step against the JAX step, one
even iteration from a shared state (``test_torch_train_fused.one_iteration``):
``use_vel`` off (3 input features, no velocity transfer: the temporal critic
sees positions only), the lowres inputs from the batch (no device sampling)
and ``freeze_D`` (no critic update, while the critics' batch-norm and
spectral-norm state still moves). ``--interp capped`` has its own file,
``tests/test_torch_train_capped.py`` (each JAX step compiles for a minute).
"""

from test_torch_train_fused import one_iteration
from test_train_step import TINY_FLUID
from tpugan_tpu.config import replace


def test_step_novel_lowres_freeze_d_matches_jax(rng, tmp_path, monkeypatch):
    cfg = replace(TINY_FLUID, use_vel=False, in_node_feats=3,
                  device_sampling=False, freeze_D=True, ml_gate=1e9)
    got, _ = one_iteration(cfg, rng, tmp_path, monkeypatch)
    assert got["tempo_G_loss"] != 0.0 and got["spatial_G_loss"] != 0.0
    assert got["tempo_D_loss"] == 0.0 == got["spatial_D_loss"]
