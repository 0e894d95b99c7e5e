"""The port's reference-checkpoint converter (``train/torch_convert.py``)
against the JAX package's (``tpugan_tpu/train/torch_convert.py``).

The reference's pretrained blobs are absent, so the checkpoints are
hand-built state_dicts with the reference's key names and torch layouts
([out, in, 1, 1] convs, [out, in] linears, ``weight_orig`` spectral-norm
keys on the critics), built as ``tests/test_torch_convert.py`` builds them
from the JAX entry tables, with weights scaled by 1 / sqrt(fan-in) so a
forward stays in range. Held: the entry tables equal, the converted arrays
equal the JAX converter's bit for bit (through ``state_dict_from_flax``),
and an SRNet forward from the converted weights against the JAX one from
its converted weights, to the tolerances of ``tests/test_torch_srnet.py``.
"""

import flax
import jax
import numpy as np
import pytest
import torch

import tpugan_tpu.train.torch_convert as jconv
import tpugan_tpu_torch.train.torch_convert as conv
from test_torch_convert import _fixture_from_entries
from test_torch_srnet import GraphReplay, assert_forward_close
from test_torch_train_step import port_config
from tpugan_tpu.config import FluidTrainConfig
from tpugan_tpu.models import SRNet as JaxSRNet
from tpugan_tpu.train import init_fluid_state as jax_init_fluid_state
from tpugan_tpu_torch.checkpoint import state_dict_from_flax
from tpugan_tpu_torch.config import ActionTrainConfig
from tpugan_tpu_torch.models.generator import SRNet
from tpugan_tpu_torch.train.state import init_action_state, init_fluid_state

NETS = (("sr", "sr_net", "sr_net_fluid"), ("tempo", "tempo_dis", "fluid_tempo"),
        ("spatial", "spatial_dis", "fluid_spatial"))


def _scaled(sd, entries):
    """Weights over sqrt(fan-in), vectors by 0.1 (variances kept positive)."""
    out = dict(sd)
    for _, fpath, tkey, kind in entries:
        for k in (tkey, tkey.replace(".weight", ".weight_orig")):
            if k not in out:
                continue
            v = out[k]
            if kind in ("conv", "linear"):
                out[k] = v / np.sqrt(v.shape[1])
            elif fpath[-1] == "var":
                out[k] = np.abs(v) + 0.5
            else:
                out[k] = 0.1 * v
    return out


@pytest.fixture(scope="module")
def fluid():
    """The JAX fluid state at the widths of tests/test_torch_convert.py, a
    reference checkpoint of its shapes, and the JAX converter's result."""
    cfg = FluidTrainConfig(batch_size=2, patch_size=128, node_embedding=32)
    _, _, state = jax_init_fluid_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    ckpt = {"n_iter": 4321}
    for net, name, table in NETS:
        entries = jconv.ENTRY_BUILDERS[table]()
        jnet = getattr(state, net)
        bs = getattr(jnet, "batch_stats", {}) if net != "sr" else {}
        sn = {t for _, _, t, k in entries
              if k in ("conv", "linear") and net != "sr"}
        ckpt[name] = _scaled(_fixture_from_entries(entries, jnet.params, bs,
                                                   rng, sn_keys=sn), entries)
    return cfg, ckpt, jconv.convert_torch_checkpoint_dict(ckpt, state, "fluid")


@pytest.mark.parametrize("table", sorted(jconv.ENTRY_BUILDERS))
def test_entry_tables_match_jax(table):
    assert conv.ENTRY_BUILDERS[table]() == jconv.ENTRY_BUILDERS[table]()


def test_strip_spectral_norm_matches_jax():
    sd = {"a.weight_orig": 1, "a.weight_u": 2, "a.weight_v": 3, "a.bias": 4,
          "b.parametrizations.weight.original": 5,
          "b.parametrizations.weight._u": 6,
          "b.parametrizations.weight._v": 7,
          "c.running_mean": 8, "c.num_batches_tracked": 9}
    assert conv.strip_spectral_norm(sd) == jconv.strip_spectral_norm(sd) == {
        "a.weight": 1, "a.bias": 4, "b.weight": 5, "c.running_mean": 8}


def test_fluid_checkpoint_converts_to_the_jax_arrays(fluid):
    """Every converted tensor equals the JAX converter's array (through the
    checkpoint bridge) bit for bit; spectral-norm state stays; n_iter
    transfers."""
    cfg, ckpt, jstate = fluid
    state = init_fluid_state(port_config(cfg), 0, "cpu")
    before = {net: {k: v.clone() for k, v in
                    getattr(state, net).module.state_dict().items()}
              for net, _, _ in NETS}
    conv.convert_torch_checkpoint_dict(ckpt, state, "fluid")
    assert state.n_iter == 4321
    for net, name, table in NETS:
        jnet = getattr(jstate, net)
        want = state_dict_from_flax(
            {"params": flax.core.unfreeze(jnet.params),
             "batch_stats": flax.core.unfreeze(
                 getattr(jnet, "batch_stats", None) or {})})
        got = getattr(state, net).module.state_dict()
        keys = {conv.port_key(p) for _, p, _, _ in conv.ENTRY_BUILDERS[table]()}
        assert keys <= set(got)
        for k in keys:
            assert torch.equal(got[k], want[k]), (net, k)
        for k, v in got.items():
            if k not in keys:                 # u, sigma: not converted
                assert torch.equal(v, before[net][k]), (net, k)
        _, leftover = conv.convert_state_dict(
            ckpt[name], conv.ENTRY_BUILDERS[table](),
            getattr(state, net).module)
        assert leftover == []


def test_action_checkpoint_round_trips():
    """The action tables on the port's action networks: a state_dict built
    from the port's own shapes (reference layout, spectral norm on the
    critics) converts back to exactly those tensors."""
    state = init_action_state(ActionTrainConfig(), 1, "cpu")
    rng = np.random.default_rng(1)
    ckpt, want = {"n_iter": 7}, {}
    for net, name, table in (("sr", "sr_net", "sr_net_action"),
                             ("tempo", "tempo_dis", "action_tempo"),
                             ("spatial", "spatial_dis", "action_spatial")):
        sd = getattr(state, net).module.state_dict()
        ref = {}
        for _, fpath, tkey, kind in conv.ENTRY_BUILDERS[table]():
            v = rng.standard_normal(tuple(sd[conv.port_key(fpath)].shape)
                                    ).astype(np.float32)
            want[(net, conv.port_key(fpath))] = v
            if kind == "conv":
                v = v[:, :, None, None]
            if kind in ("conv", "linear") and net != "sr":
                tkey = tkey.replace(".weight", ".weight_orig")
            ref[tkey] = torch.from_numpy(v)
        ckpt[name] = ref
    conv.convert_torch_checkpoint_dict(ckpt, state, "action")
    assert state.n_iter == 7
    for (net, key), v in want.items():
        assert np.array_equal(
            getattr(state, net).module.state_dict()[key].numpy(), v)


def test_srnet_forward_from_converted_weights_matches_jax(fluid,
                                                          monkeypatch):
    cfg, ckpt, jstate = fluid
    rng = np.random.default_rng(2)
    pos = (rng.standard_normal((1, 256, 3)) * 0.3).astype(np.float32)
    jm = JaxSRNet(in_feats=3, node_emb_dim=32, upsample_ratio=8)
    replay = GraphReplay(monkeypatch)
    out_j = replay.jax_forward(jm, {"params": jstate.sr.params}, pos, pos)
    tm = SRNet(in_feats=3, node_emb_dim=32, upsample_ratio=8, device="cpu")
    sd, leftover = conv.convert_state_dict(
        ckpt["sr_net"], conv.ENTRY_BUILDERS["sr_net_fluid"](), tm)
    assert leftover == []
    tm.load_state_dict(sd)
    replay.replay()
    with torch.no_grad():
        out_t = tm(torch.from_numpy(pos), torch.from_numpy(pos))
    assert not replay.lists
    assert np.isfinite(out_t[0].numpy()).all()
    assert_forward_close(out_j, out_t, tm.epsilon, 8)


def test_missing_key_shape_mismatch_and_loose_mode(fluid):
    cfg, ckpt, _ = fluid
    tm = SRNet(in_feats=3, node_emb_dim=32, upsample_ratio=8, device="cpu")
    entries = conv.ENTRY_BUILDERS["sr_net_fluid"]()
    sd = dict(ckpt["sr_net"])
    sd.pop("upsampling_block.decoder.1.bias")
    with pytest.raises(KeyError, match="decoder.1.bias"):
        conv.convert_state_dict(sd, entries, tm)
    got, leftover = conv.convert_state_dict(dict(sd, extra=np.zeros(2)),
                                            entries, tm, strict=False)
    assert leftover == ["extra"]
    assert torch.equal(got["upsampling_block.Dense_0.bias"],
                       tm.state_dict()["upsampling_block.Dense_0.bias"])
    sd["upsampling_block.decoder.1.bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        conv.convert_state_dict(sd, entries, tm)
