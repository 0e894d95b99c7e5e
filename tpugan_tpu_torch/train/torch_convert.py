"""Reference (PyTorch) checkpoint -> the port's module states
(``tpugan_tpu/train/torch_convert.py``).

The reference saves torch-pickled dicts ``{sr_net, tempo_dis, spatial_dis,
n_iter, *_optim, *_sched}`` of module ``state_dict()``s (reference
utils.py:7-43, train_tempo.py:300-317). This module maps those
state_dicts onto the port's modules, whose parameter names are the flax
scopes of the JAX package (``checkpoint.py``), so the authors' pretrained
checkpoints load for rollout and evaluation.

Mapping rules (from the reference module constructors), each entry of a
table naming the flax path, the reference key and the transform:

* 1x1 ``nn.Conv2d`` weights ``[out, in, 1, 1]`` -> ``weight`` ``[out, in]``;
  ``nn.Linear`` weights ``[out, in]`` as they are (the port keeps torch's
  layout, where the flax tree transposes both);
* spectral norm (``weight_orig`` / ``weight_u`` / ``weight_v``, or the newer
  ``parametrizations.weight.*``) is stripped to the raw weight, as the
  reference's own transfer loader does (discriminator.py:674-685); the
  port's ``u`` and ``sigma`` stay as they were (the power iteration
  re-estimates them in a few forward passes);
* BatchNorm ``weight`` / ``bias`` -> ``scale`` / ``bias``,
  ``running_mean`` / ``running_var`` -> ``mean`` / ``var``;
  ``num_batches_tracked`` is dropped.

Optimiser and scheduler states are not converted (Adam's moments are the
framework's own): a converted checkpoint restarts optimisation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# (collection, flax path, reference key, transform kind)
Entry = Tuple[str, Tuple[str, ...], str, str]


# ---------------------------------------------------------------------------
# the reference's state_dict

def strip_spectral_norm(sd: Dict[str, object]) -> Dict[str, object]:
    """Spectral-norm parametrisation keys collapsed to plain ``weight``:
    the legacy ``weight_orig`` / ``weight_u`` / ``weight_v`` layout and the
    newer ``parametrizations.weight.original`` / ``._u`` / ``._v``; every
    ``num_batches_tracked`` dropped."""
    out = {}
    for k, v in sd.items():
        if k.endswith(("weight_u", "weight_v", "num_batches_tracked")):
            continue
        if (".parametrizations.weight._u" in k
                or ".parametrizations.weight._v" in k):
            continue
        if k.endswith("weight_orig"):
            k = k[:-len("_orig")]
        out[k.replace(".parametrizations.weight.original", ".weight")] = v
    return out


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _transform(value: np.ndarray, kind: str) -> np.ndarray:
    """A reference tensor in the port's layout."""
    if kind == "conv":            # [out, in, 1, 1] (or [out, in])
        return value[:, :, 0, 0] if value.ndim == 4 else value
    if kind in ("linear", "vec"):
        return value
    raise ValueError(f"unknown transform kind {kind}")


def port_key(path: Tuple[str, ...]) -> str:
    """The port's state_dict key of a flax path (``kernel`` -> ``weight``;
    ``scale``, ``bias``, ``mean`` and ``var`` keep their names)."""
    *mods, leaf = path
    return ".".join(mods + ["weight" if leaf == "kernel" else leaf])


# ---------------------------------------------------------------------------
# entry tables (one builder per reference module pattern)

def _dense(fp, tp, kind="conv") -> Entry:
    return ("params", fp + ("Dense_0", "kernel"), tp, kind)


def _edgeconv(fp: Tuple[str, ...], tp: str, mlp_layer: bool = True
              ) -> List[Entry]:
    """gcn_lib/pointnet/gcn.py:150-212: the node and edge affines (conv at
    .0) and the mlp (convs at .0 and .2, or one conv_bn_layer without
    ``mlp_layer``)."""
    e = [_dense(fp + ("ConvLayer_0",), tp + ".node_affine.0.weight"),
         _dense(fp + ("ConvLayer_1",), tp + ".edge_affine.0.weight")]
    if mlp_layer:
        e += [_dense(fp + ("SharedMLP_0", "ConvLayer_0"), tp + ".mlp.0.weight"),
              _dense(fp + ("SharedMLP_0", "ConvLayer_1"), tp + ".mlp.2.weight")]
    else:
        e.append(_dense(fp + ("ConvLayer_2",), tp + ".mlp.0.weight"))
    return e


def _idgcn(fp: Tuple[str, ...], tp: str) -> List[Entry]:
    """gcn_lib/pointnet/gcn.py:215-279: btn, GCN1, GCN2, decoder,
    skip_layer."""
    e = [_dense(fp + ("ConvLayer_0",), tp + ".btn.0.weight")]
    e += _edgeconv(fp + ("EdgeConv_0",), tp + ".GCN1")
    e += _edgeconv(fp + ("EdgeConv_1",), tp + ".GCN2")
    e += [_dense(fp + ("ConvLayer_1",), tp + ".decoder.0.weight"),
          _dense(fp + ("ConvLayer_2",), tp + ".skip_layer.0.weight")]
    return e


def _upsampling_head(fp: Tuple[str, ...], tp: str, mask_head: bool
                     ) -> List[Entry]:
    """UpsamplingModule / BinaryMaskingModule (upsampling_network.py:44-104):
    [conv down by 4, EdgeConv] twice, then the decoder (a shared MLP and a
    biased conv). The masking head's last EdgeConv has mlp_layer=False."""
    up = tp + ".upsample_layers"
    e = [_dense(fp + ("ConvLayer_0",), up + ".0.0.weight")]
    e += _edgeconv(fp + ("EdgeConv_0",), up + ".1")
    e.append(_dense(fp + ("ConvLayer_1",), up + ".2.0.weight"))
    e += _edgeconv(fp + ("EdgeConv_1",), up + ".3", mlp_layer=not mask_head)
    e += [_dense(fp + ("SharedMLP_0", "ConvLayer_0"), tp + ".decoder.0.0.weight"),
          _dense(fp + ("SharedMLP_0", "ConvLayer_1"), tp + ".decoder.0.2.weight"),
          ("params", fp + ("Dense_0", "kernel"), tp + ".decoder.1.weight",
           "conv"),
          ("params", fp + ("Dense_0", "bias"), tp + ".decoder.1.bias", "vec")]
    return e


def generator_entries(depth: int = 3, masked: bool = True) -> List[Entry]:
    """SRNet (``masked``) / NoMaskSRNet (upsampling_network.py:108-223)."""
    e = _edgeconv(("feature_extractor", "EdgeConv_0"),
                  "feature_extractor.conv_layers.0")
    for i in range(1, depth):
        e += _idgcn(("feature_extractor", f"IDGCNLayer_{i - 1}"),
                    f"feature_extractor.conv_layers.{i}")
    e += _upsampling_head(("upsampling_block",), "upsampling_block", False)
    if masked:
        e += _upsampling_head(("filter_block",), "filter_block", True)
    return e


def _bn(fp: Tuple[str, ...], tp: str) -> List[Entry]:
    return [("params", fp + ("scale",), tp + ".weight", "vec"),
            ("params", fp + ("bias",), tp + ".bias", "vec"),
            ("batch_stats", fp + ("mean",), tp + ".running_mean", "vec"),
            ("batch_stats", fp + ("var",), tp + ".running_var", "vec")]


def _ssg(fp: Tuple[str, ...], tp: str, n_layers: int) -> List[Entry]:
    """SSGSetConv (discriminator.py:203-232): build_shared_mlp with bn=True
    (discriminator.py:63-78), a Sequential of stride 3: conv at 3i,
    BatchNorm2d at 3i + 1, the activation at 3i + 2."""
    e: List[Entry] = []
    for i in range(n_layers):
        cp = fp + ("SharedMLP_0", f"ConvLayer_{i}")
        e.append(_dense(cp, f"{tp}.mlps.0.{3 * i}.weight"))
        e += _bn(cp + ("BatchNorm_0",), f"{tp}.mlps.0.{3 * i + 1}")
    return e


def _flow_embedding(fp: Tuple[str, ...], tp: str, n_layers: int = 3
                    ) -> List[Entry]:
    """FlowEmbedding (discriminator.py:235-283): mlp_convs.{j} (bias-free
    1x1 convs) and mlp_bns.{j}."""
    e: List[Entry] = []
    for j in range(n_layers):
        e.append(("params", fp + (f"Dense_{j}", "kernel"),
                  f"{tp}.mlp_convs.{j}.weight", "conv"))
        e += _bn(fp + (f"BatchNorm_{j}",), f"{tp}.mlp_bns.{j}")
    return e


def _flow_module(fp: Tuple[str, ...], tp: str, sequence_length: int = 3
                 ) -> List[Entry]:
    e: List[Entry] = []
    for i in range(sequence_length - 1):
        e += _flow_embedding(fp + (f"flow_emb_layers_{i}",),
                             f"{tp}.flow_emb_layers.{i}")
    return e


def _fc_head(fp: Tuple[str, ...], tp: str) -> List[Entry]:
    """fc_layers (discriminator.py:356-364 et al.): Linear at 0,
    BatchNorm1d at 1, Linear at 4, BatchNorm1d at 5, Linear at 8 (the
    activations and dropouts between hold no state)."""
    e: List[Entry] = []
    for i, ti in enumerate((0, 4, 8)):
        e += [("params", fp + (f"Dense_{i}", "kernel"), f"{tp}.{ti}.weight",
               "linear"),
              ("params", fp + (f"Dense_{i}", "bias"), f"{tp}.{ti}.bias",
               "vec")]
    e += _bn(fp + ("BatchNorm_0",), f"{tp}.1")
    e += _bn(fp + ("BatchNorm_1",), f"{tp}.5")
    return e


def fluid_tempo_entries(sequence_length: int = 3) -> List[Entry]:
    """FluidTempoDis (discriminator.py:473-516)."""
    e = _ssg(("sa1",), "coarse_graining_module.0", 2)
    e += _ssg(("sa2",), "coarse_graining_module.1", 2)
    e += _flow_module(("flow_module",), "flow_module", sequence_length)
    e += _ssg(("sa_pooling",), "SA_pooling", 2)
    e += _fc_head(("fc",), "fc_layers")
    return e


def fluid_spatial_entries() -> List[Entry]:
    """FluidSpatialDis (discriminator.py:562-629)."""
    e: List[Entry] = []
    for i in range(3):
        e += _ssg((f"sa_{i}",), f"coarse_graining_module.{i}", 2)
    e += _ssg(("sa_pooling",), "SA_pooling", 2)
    e += _fc_head(("fc",), "fc_layers")
    return e


def action_tempo_entries(sequence_length: int = 3) -> List[Entry]:
    """ActionTempoDis (discriminator.py:325-364); the tower's first level
    has a 3-conv MLP ([3, 64, 64, 128])."""
    e = _ssg(("tower", "sa1"), "coarse_graining_module.0", 3)
    e += _ssg(("tower", "sa2"), "coarse_graining_module.1", 2)
    e += _flow_module(("tower", "flow_module"), "flow_module", sequence_length)
    e += _ssg(("tower", "sa_pooling"), "SA_pooling", 2)
    e += _fc_head(("fc",), "fc_layers")
    return e


def action_spatial_entries() -> List[Entry]:
    """ActionSpatialDis (discriminator.py:405-452)."""
    e = _ssg(("sa_0",), "coarse_graining_module.0", 3)
    e += _ssg(("sa_1",), "coarse_graining_module.1", 2)
    e += _ssg(("sa_2",), "coarse_graining_module.2", 2)
    e += _ssg(("sa_pooling",), "SA_pooling", 2)
    e += _fc_head(("fc",), "fc_layers")
    return e


ENTRY_BUILDERS = {
    "sr_net_fluid": lambda: generator_entries(masked=True),
    "sr_net_action": lambda: generator_entries(masked=False),
    "fluid_tempo": fluid_tempo_entries,
    "fluid_spatial": fluid_spatial_entries,
    "action_tempo": action_tempo_entries,
    "action_spatial": action_spatial_entries,
}


# ---------------------------------------------------------------------------
# applying a table

def convert_state_dict(torch_sd: Dict[str, object], entries: List[Entry],
                       module: torch.nn.Module, strict: bool = True
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(``module``'s state_dict with every entry's tensor replaced by the
    reference's, the reference keys no entry took). ``strict`` raises when
    an entry's reference key is missing; a key the module lacks or a shape
    that disagrees always raises. The module itself is not changed."""
    sd = {k: _to_numpy(v) for k, v in strip_spectral_norm(torch_sd).items()}
    out = {k: v.detach().clone() for k, v in module.state_dict().items()}
    consumed = set()
    for _, fpath, tkey, kind in entries:
        if tkey not in sd:
            if strict:
                raise KeyError(f"torch state_dict missing {tkey} "
                               f"(for {'/'.join(fpath)})")
            continue
        key = port_key(fpath)
        if key not in out:
            raise KeyError(f"the module has no {key} (while mapping {tkey})")
        value = _transform(sd[tkey], kind)
        if tuple(out[key].shape) != value.shape:
            raise ValueError(f"shape mismatch mapping {tkey} -> {key}: torch "
                             f"{value.shape} vs port {tuple(out[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(
            dtype=out[key].dtype, device=out[key].device)
        consumed.add(tkey)
    return out, sorted(set(sd) - consumed)


def convert_torch_checkpoint_dict(ckpt: dict, state, workload: str = "fluid",
                                  strict: bool = True):
    """A reference checkpoint dict loaded into ``state`` (a
    ``GanTrainState``: SRNet and the fluid critics for ``workload``
    "fluid", NoMaskSRNet and the action critics for "action"): the three
    networks' weights and running moments, and ``n_iter``. The optimisers
    stay as they were. Returns ``state``."""
    prefix = "fluid" if workload == "fluid" else "action"
    for net, key, table in (("sr", "sr_net", f"sr_net_{prefix}"),
                            ("tempo", "tempo_dis", f"{prefix}_tempo"),
                            ("spatial", "spatial_dis", f"{prefix}_spatial")):
        module = getattr(state, net).module
        sd, _ = convert_state_dict(ckpt[key], ENTRY_BUILDERS[table](), module,
                                   strict)
        module.load_state_dict(sd)
    state.n_iter = int(ckpt.get("n_iter", 0))
    return state


def load_torch_checkpoint(path: str, state, workload: str = "fluid",
                          strict: bool = True):
    """A reference torch checkpoint file loaded into ``state`` (see
    :func:`convert_torch_checkpoint_dict`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_torch_checkpoint_dict(ckpt, state, workload, strict)
