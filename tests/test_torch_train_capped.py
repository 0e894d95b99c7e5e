"""The train step's capped velocity transfer (``interp="capped"``: the
reference's 32 nearest within the cutoff) against the JAX step, one even
iteration from a shared state (``test_torch_train_fused.one_iteration``),
so the temporal critic's generator loss and both critics' updates read the
capped features.
"""

from test_torch_train_fused import one_iteration
from test_train_step import TINY_FLUID
from tpugan_tpu.config import replace


def test_step_capped_interp_matches_jax(rng, tmp_path, monkeypatch):
    cfg = replace(TINY_FLUID, use_vel=True, in_node_feats=6,
                  device_sampling=True, interp="capped", ml_gate=1e9)
    got, _ = one_iteration(cfg, rng, tmp_path, monkeypatch)
    assert got["tempo_D_loss"] != 0.0 and got["spatial_D_loss"] != 0.0
