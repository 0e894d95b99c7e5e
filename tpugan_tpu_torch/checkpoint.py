"""Flax msgpack checkpoints carried into the port.

``read_flax_msgpack`` is a small msgpack decoder of its own (the port
imports no ``msgpack`` and no flax). It covers what ``flax.serialization``
writes: maps, arrays, str, bin, ints, floats, nil, bool, and the extension
types 1 (ndarray: a msgpack ``(shape, dtype_name, bytes)`` triple, flax's
``_ndarray_to_bytes``) and 3 (a numpy scalar, packed as a 0-d ndarray).

``state_dict_from_flax`` turns a flax ``{"params", "batch_stats"}`` tree
into a ``state_dict``: the torch modules carry the flax scope names, so
``a/b/Dense_0/kernel [in, out]`` becomes ``a.b.Dense_0.weight [out, in]``,
``bias`` / ``scale`` / ``mean`` / ``var`` keep their names, and a spectral
norm's ``a/SpectralNorm_0/Dense_0/kernel/u`` becomes ``a.SpectralNorm_0.u``.
``load_srnet`` builds the serving generator from a checkpoint,
``load_nomask_srnet`` the action workload's generator and
``load_action_tempo_dis`` its temporal critic; ``load_trainer_state`` and
``load_action_trainer_state`` the whole fluid and action trainer (three
networks, three Adam states, the iteration count).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        lengths = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= t <= 0xC6:                                   # bin 8/16/32
            return bytes(self.take(self.unpack(lengths[t - 0xC4])))
        if 0xD9 <= t <= 0xDB:                                   # str 8/16/32
            return str(self.take(self.unpack(lengths[t - 0xD9])), "utf-8")
        if t in (0xDC, 0xDD):                                   # array 16/32
            return self.array(self.unpack(lengths[t - 0xDB]))
        if t in (0xDE, 0xDF):                                   # map 16/32
            return self.map(self.unpack(lengths[t - 0xDD]))
        if 0xD4 <= t <= 0xD8:                                   # fixext 1..16
            return self.ext(1 << (t - 0xD4))
        if 0xC7 <= t <= 0xC9:                                   # ext 8/16/32
            return self.ext(self.unpack(lengths[t - 0xC7]))
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported extension type {code}")
        shape, dtype_name, raw = _Reader(bytes(payload)).value()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        if dtype_name == "bfloat16":
            # numpy has no bfloat16: widen exactly to float32
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32).reshape(shape)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def read_flax_msgpack(path) -> Dict[str, Any]:
    """Decode a flax msgpack file into nested dicts of numpy arrays (the tree
    ``flax.serialization.msgpack_restore`` returns)."""
    with open(path, "rb") as fh:
        reader = _Reader(fh.read())
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing bytes")
    return tree


def _leaves(tree: Dict[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_key(path, collection: str):
    """(torch state_dict key, transpose?) of a flax leaf path."""
    *mods, leaf = path
    if collection == "params":
        if leaf == "kernel":
            return ".".join(mods + ["weight"]), True
        if leaf in ("bias", "scale"):
            return ".".join(mods + [leaf]), False
    elif collection == "batch_stats":
        if leaf in ("mean", "var"):
            return ".".join(mods + [leaf]), False
        # a spectral norm's SpectralNorm_i/Dense_j/kernel/{u, sigma}
        if (leaf in ("u", "sigma") and len(mods) >= 3 and mods[-1] == "kernel"
                and mods[-3].startswith("SpectralNorm_")):
            return ".".join(mods[:-2] + [leaf]), False
    raise ValueError(f"unexpected flax leaf {collection}/{'/'.join(path)}")


def _tree_to_torch(tree: Dict[str, Any], collection: str) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, leaf in _leaves(tree):
        # a live flax tree names spectral-norm stats "Dense_0/kernel/u"
        path = tuple(part for p in path for part in str(p).split("/"))
        key, transpose = _torch_key(path, collection)
        arr = np.asarray(leaf, dtype=np.float32)
        sd[key] = torch.from_numpy((arr.T if transpose else arr).copy())
    return sd


def _check_against(sd: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                   what: str) -> None:
    """Raise if a leaf has no torch tensor, a tensor is left unfilled, or a
    shape disagrees."""
    extra = sorted(set(sd) - set(want))
    missing = sorted(set(want) - set(sd))
    if extra or missing:
        raise ValueError(f"{what}: flax leaves without a torch parameter: "
                         f"{extra}; torch parameters left unfilled: {missing}")
    bad = [k for k in sd if sd[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"{what}: shape mismatch: " + ", ".join(
            f"{k} {tuple(sd[k].shape)} vs {tuple(want[k].shape)}" for k in bad))


def state_dict_from_flax(variables: Dict[str, Any],
                         model: Optional[torch.nn.Module] = None,
                         what: str = "network") -> Dict[str, torch.Tensor]:
    """A flax ``{"params", "batch_stats"}`` tree -> ``state_dict`` (CPU
    tensors): Dense kernels transposed into ``weight``, BatchNorm
    scale / bias / mean / var, spectral-norm u / sigma. With ``model``,
    raises on any leaf or tensor left over (see :func:`_check_against`)."""
    sd = {}
    for collection in ("params", "batch_stats"):
        sd.update(_tree_to_torch(variables.get(collection, {}), collection))
    if model is not None:
        _check_against(sd, model.state_dict(), what)
    return sd


def srnet_params_from_flax(tree: Dict[str, Any],
                           model: Optional[torch.nn.Module] = None
                           ) -> Dict[str, torch.Tensor]:
    """``sr_net/params`` tree -> SRNet ``state_dict`` (CPU tensors).

    With ``model``, raises if any flax leaf has no torch parameter, any
    parameter is left unfilled, or a shape disagrees."""
    return state_dict_from_flax({"params": tree}, model, "sr_net")


def adam_from_flax(opt_state: Dict[str, Any], net) -> None:
    """Fill a :class:`~tpugan_tpu_torch.train.state.NetState`'s Adam from an
    optax ``chain(scale_by_adam, scale_by_schedule)`` state: ``'0'`` holds
    Adam's count / mu / nu, ``'1'`` the schedule's count. Raises on any
    moment left over or unfilled."""
    adam, sched = opt_state["0"], opt_state["1"]
    if set(adam) != {"count", "mu", "nu"} or set(sched) != {"count"}:
        raise ValueError(f"unexpected optimiser state keys {sorted(adam)}, "
                         f"{sorted(sched)}")
    opt = net.opt
    for name in ("mu", "nu"):
        sd = _tree_to_torch(adam[name], "params")
        _check_against(sd, {k: p.detach() for k, p in opt.params.items()},
                       f"adam {name}")
        moments = getattr(opt, name)
        for k, v in sd.items():
            moments[k] = v.to(opt.params[k].device)
    opt.count = int(adam["count"])
    opt.sched_count = int(sched["count"])


_TRAINER_ENTRIES = {"sr_net", "tempo_dis", "spatial_dis", "sr_optim",
                    "tempo_optim", "spatial_optim", "n_iter"}


def _load_trainer(path, cfg, sr_cls, critics, device, fused_train):
    """The trainer state of a checkpoint (file or directory) as a
    :class:`~tpugan_tpu_torch.train.state.GanTrainState`: the generator of
    ``sr_cls`` shaped by its weights, ``critics`` (name -> module, built on
    ``device``) filled from ``tempo_dis`` / ``spatial_dis``, the three Adam
    states and ``n_iter``; learning rates and schedule from ``cfg``.
    Raises on an unexpected entry, a leaf left over or a tensor left
    unfilled."""
    from tpugan_tpu_torch.train.state import trainer_state

    tree = read_flax_msgpack(resolve_checkpoint(path))
    extra = set(tree) - _TRAINER_ENTRIES
    if extra:
        raise ValueError(f"unexpected trainer-state entries {sorted(extra)}")
    nets = {"sr": _generator(sr_cls, tree["sr_net"]["params"], device,
                             dict(fused_train=fused_train)), **critics}
    for name, flax_name in (("tempo", "tempo_dis"), ("spatial", "spatial_dis")):
        nets[name].load_state_dict(state_dict_from_flax(
            tree[flax_name], nets[name], flax_name))
    state = trainer_state(cfg, int(tree["n_iter"]), nets)
    for name in ("sr", "tempo", "spatial"):
        adam_from_flax(tree[f"{name}_optim"], getattr(state, name))
    return state


def load_trainer_state(path, cfg=None, device=None, fused_train=False):
    """The whole fluid trainer state of a flax msgpack checkpoint (a file,
    or a directory through its ``latest_checkpoint.txt`` manifest):
    ``sr_net``, ``tempo_dis`` and ``spatial_dis`` (params, BatchNorm
    running moments, spectral-norm u / sigma), their three Adam states and
    ``n_iter``, as a :class:`~tpugan_tpu_torch.train.state.GanTrainState`
    on ``device`` (the card when None). ``cfg`` (a
    :class:`~tpugan_tpu_torch.train.step.FluidTrainConfig`, the train_vel
    defaults when None) gives the learning rates and schedule;
    ``fused_train`` goes to the SRNet. Raises on any leaf left over or
    tensor left unfilled."""
    from tpugan_tpu_torch import resolve_device
    from tpugan_tpu_torch.models.discriminator import (FluidSpatialDis,
                                                       FluidTempoDis)
    from tpugan_tpu_torch.models.generator import SRNet
    from tpugan_tpu_torch.train.step import FluidTrainConfig

    device = resolve_device(device)
    return _load_trainer(path, cfg or FluidTrainConfig(), SRNet,
                         {"tempo": FluidTempoDis(3, device=device),
                          "spatial": FluidSpatialDis(device=device)},
                         device, fused_train)


def load_action_trainer_state(path, cfg=None, device=None, fused_train=False):
    """The whole action trainer state of a flax msgpack checkpoint (a file,
    or a directory through its manifest; the committed
    ``checkpoints/action_tempo_20k.ckpt`` holds one at n_iter 20,000):
    NoMaskSRNet, ActionTempoDis over ``cfg.frames_per_clip`` frames and
    ActionSpatialDis (params, BatchNorm running moments, spectral-norm u /
    sigma), their three Adam states and ``n_iter``, on ``device`` (the card
    when None). ``cfg`` (an ``ActionTrainConfig``, its defaults when None)
    gives the learning rates and schedule; ``fused_train`` goes to the
    NoMaskSRNet. Raises on any leaf left over or tensor left unfilled."""
    from tpugan_tpu_torch import resolve_device
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.models.discriminator import (ActionSpatialDis,
                                                       ActionTempoDis)
    from tpugan_tpu_torch.models.generator import NoMaskSRNet

    cfg = cfg or ActionTrainConfig()
    device = resolve_device(device)
    return _load_trainer(path, cfg, NoMaskSRNet,
                         {"tempo": ActionTempoDis(cfg.frames_per_clip,
                                                  device=device),
                          "spatial": ActionSpatialDis(device=device)},
                         device, fused_train)


def resolve_checkpoint(path) -> str:
    """``path`` itself, or for a directory of checkpoints the one its
    ``latest_checkpoint.txt`` manifest names (first line)."""
    path = os.fspath(path)
    if os.path.isdir(path):
        with open(os.path.join(path, "latest_checkpoint.txt")) as fh:
            path = os.path.join(path, fh.readline().strip())
    return path


def _generator_kwargs(params: Dict[str, Any]) -> Dict[str, int]:
    """in_feats, node_emb_dim, upsample_ratio and feature_extractor_depth
    of a generator's flax params, read off the weight shapes."""
    fe = params["feature_extractor"]
    in_feats, half = fe["EdgeConv_0"]["ConvLayer_0"]["Dense_0"]["kernel"].shape
    return dict(
        in_feats=int(in_feats), node_emb_dim=2 * int(half),
        upsample_ratio=int(params["upsampling_block"]["Dense_0"]["bias"].shape[0]) // 3,
        feature_extractor_depth=1 + sum(k.startswith("IDGCNLayer_") for k in fe))


def _generator(cls, params, device, model_kwargs):
    """A generator of ``cls`` shaped by and loaded with ``params`` (a
    checkpoint's ``sr_net/params``)."""
    model = cls(**_generator_kwargs(params), device=device, **model_kwargs)
    model.load_state_dict(srnet_params_from_flax(params, model), strict=True)
    return model


def _load_generator(cls, path, device, model_kwargs):
    params = read_flax_msgpack(resolve_checkpoint(path))["sr_net"]["params"]
    return _generator(cls, params, device, model_kwargs)


def load_srnet(path, device=None, **model_kwargs):
    """Build an :class:`SRNet` matching a trained checkpoint and load its
    ``sr_net`` weights. ``path`` is a checkpoint file or a directory with a
    ``latest_checkpoint.txt`` manifest. in_feats, node_emb_dim, the
    upsample ratio and the extractor depth are read off the weight shapes;
    ``model_kwargs`` sets the rest (``compute_dtype``, ``graph_mode``, ...)."""
    from tpugan_tpu_torch.models.generator import SRNet

    return _load_generator(SRNet, path, device, model_kwargs)


def load_nomask_srnet(path, device=None, **model_kwargs):
    """The action workload's :class:`NoMaskSRNet` of a trained checkpoint's
    ``sr_net`` weights, shaped and built as :func:`load_srnet` builds the
    SRNet (the committed ``checkpoints/action_tempo_20k.ckpt``: in_feats 3,
    width 128, r 16, depth 3)."""
    from tpugan_tpu_torch.models.generator import NoMaskSRNet

    return _load_generator(NoMaskSRNet, path, device, model_kwargs)


def load_action_tempo_dis(path, device=None):
    """The action temporal critic :class:`ActionTempoDis` of a checkpoint's
    ``tempo_dis`` tree: params, BatchNorm running moments and spectral-norm
    u / sigma; its sequence length is read off the flow module's depth.
    Raises on any leaf left over or tensor left unfilled."""
    from tpugan_tpu_torch.models.discriminator import ActionTempoDis

    tree = read_flax_msgpack(resolve_checkpoint(path))["tempo_dis"]
    flow = tree["params"]["tower"]["flow_module"]
    model = ActionTempoDis(1 + sum(k.startswith("flow_emb_layers_")
                                   for k in flow), device=device)
    model.load_state_dict(state_dict_from_flax(tree, model, "tempo_dis"))
    return model
