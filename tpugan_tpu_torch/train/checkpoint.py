"""Writing trainer checkpoints in the JAX package's schema
(``tpugan_tpu/train/checkpoint.py``): one flax msgpack file per checkpoint
holding ``sr_net``, ``tempo_dis``, ``spatial_dis`` (each ``{"params",
"batch_stats"}``), ``n_iter`` and the three optimiser states
``sr_optim``, ``tempo_optim``, ``spatial_optim`` in optax's layout
(``{"0": {"count", "mu", "nu"}, "1": {"count"}}``, what
``checkpoint.adam_from_flax`` reads); a newest-first
``latest_checkpoint.txt`` manifest with ``max_keep`` pruning; a
``best_model.ckpt`` copy. The JAX package's ``load_checkpoint`` reads the
files, and so does the port's ``load_trainer_state`` (a file, or a
directory through its manifest).

The encoder is the port's own (no ``msgpack`` package is assumed), the
counterpart of ``checkpoint.read_flax_msgpack``: maps with str keys, and
every array as flax writes it, the extension type 1 holding a msgpack
``(shape, dtype_name, bytes)`` triple; counts and ``n_iter`` are 0-d int32
arrays, as in a JAX trainer state. Module keys map back to flax scopes as
the reader maps them forward: ``a.b.Dense_0.weight [out, in]`` is
``a/b/Dense_0/kernel [in, out]``, a spectral norm's buffer
``a.SpectralNorm_i.u`` is ``a/SpectralNorm_i/"Dense_i/kernel/u"``.
"""

from __future__ import annotations

import os
import shutil
import struct
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

_EXT_NDARRAY = 1
MANIFEST = "latest_checkpoint.txt"

# One writer thread: serialisation and disk I/O leave the training loop's
# critical path; the tensors are copied to the host on the caller's thread,
# so the next step may update them in place.
_EXECUTOR = ThreadPoolExecutor(max_workers=1)


# ---------------------------------------------------------------- msgpack

def _head(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((byte, struct format, limit), ...) whose limit n is under."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


_LEN = ((">B", 1 << 8), (">H", 1 << 16), (">I", 1 << 32))


def _pack(v: Any, out: list) -> None:
    if isinstance(v, dict):
        out.append(_head(len(v), 0x80, 16,
                         [(0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)]))
        for k, x in v.items():
            _pack(str(k), out)
            _pack(x, out)
    elif isinstance(v, (list, tuple)):
        out.append(_head(len(v), 0x90, 16,
                         [(0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)]))
        for x in v:
            _pack(x, out)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(_head(len(raw), 0xA0, 32,
                         [(c, f, lim) for c, (f, lim) in zip((0xD9, 0xDA, 0xDB),
                                                             _LEN)]))
        out.append(raw)
    elif isinstance(v, (bytes, bytearray)):
        out.append(_head(len(v), 0, 0,
                         [(c, f, lim) for c, (f, lim) in zip((0xC4, 0xC5, 0xC6),
                                                             _LEN)]))
        out.append(bytes(v))
    elif v is None or isinstance(v, bool):
        out.append(bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[v]]))
    elif isinstance(v, (np.ndarray, np.generic)):
        arr = np.asarray(v)
        payload = _packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        n = len(payload)
        if n in (1, 2, 4, 8, 16):                        # fixext 1..16
            out.append(bytes([0xD4 + (n.bit_length() - 1)]))
        else:                                            # ext 8 / 16 / 32
            out.append(_head(n, 0, 0, [(c, f, lim) for c, (f, lim)
                                       in zip((0xC7, 0xC8, 0xC9), _LEN)]))
        out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(payload)
    elif isinstance(v, int):
        if 0 <= v < 0x80 or -32 <= v < 0:
            out.append(struct.pack(">b" if v < 0 else ">B", v))
        else:
            out.append(b"\xd3" + struct.pack(">q", v))
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    else:
        raise TypeError(f"msgpack: cannot encode {type(v).__name__}")


def _packb(v: Any) -> bytes:
    out: list = []
    _pack(v, out)
    return b"".join(out)


def write_flax_msgpack(tree: Dict[str, Any], path) -> None:
    """Encode nested dicts of numpy arrays as ``flax.serialization``
    would, and write them to ``path``."""
    with open(path, "wb") as fh:
        fh.write(_packb(tree))


# ---------------------------------------------------------------- trees

def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _host(t: torch.Tensor, transpose: bool = False) -> np.ndarray:
    arr = t.detach().float().cpu().numpy()
    return (arr.T if transpose else arr).copy(order="C")


def _params_tree(named) -> dict:
    """{torch key: tensor} of parameters (or moments shaped like them) ->
    the flax params tree: ``weight`` [out, in] becomes ``kernel`` [in, out]."""
    tree: dict = {}
    for key, t in named.items():
        *mods, leaf = key.split(".")
        kernel = leaf == "weight"
        _put(tree, mods + ["kernel" if kernel else leaf], _host(t, kernel))
    return tree


def flax_variables(module: torch.nn.Module) -> Dict[str, dict]:
    """``{"params", "batch_stats"}`` of a module, the inverse of
    ``checkpoint.state_dict_from_flax``."""
    stats: dict = {}
    for key, t in module.named_buffers():
        *mods, leaf = key.split(".")
        if leaf in ("u", "sigma"):                       # SpectralNorm_i
            index = mods[-1].rpartition("_")[2]
            leaf = f"Dense_{index}/kernel/{leaf}"
        _put(stats, mods + [leaf], _host(t))
    return {"params": _params_tree(dict(module.named_parameters())),
            "batch_stats": stats}


def _count(n: int) -> np.ndarray:
    return np.asarray(n, dtype=np.int32)


def optax_state(opt) -> Dict[str, dict]:
    """An :class:`~tpugan_tpu_torch.train.state.Adam` as optax's
    ``chain(scale_by_adam, scale_by_schedule)`` state."""
    return {"0": {"count": _count(opt.count), "mu": _params_tree(opt.mu),
                  "nu": _params_tree(opt.nu)},
            "1": {"count": _count(opt.sched_count)}}


def trainer_payload(state) -> Dict[str, Any]:
    """The checkpoint tree of a ``GanTrainState``, every array on the host."""
    payload = {flax_name: flax_variables(getattr(state, name).module)
               for name, flax_name in (("sr", "sr_net"), ("tempo", "tempo_dis"),
                                       ("spatial", "spatial_dis"))}
    payload["n_iter"] = _count(state.n_iter)
    for name in ("sr", "tempo", "spatial"):
        payload[f"{name}_optim"] = optax_state(getattr(state, name).opt)
    return payload


# ---------------------------------------------------------------- files

def write_checkpoint(payload: Dict[str, Any], save_path: str,
                     is_best: bool = False,
                     max_keep: Optional[int] = None) -> None:
    """Write a host payload (:func:`trainer_payload`) and put its file
    first in the directory's manifest; with ``max_keep``, delete the files
    the manifest drops (reference utils.py:7-43)."""
    save_dir = os.path.dirname(save_path) or "."
    os.makedirs(save_dir, exist_ok=True)
    write_flax_msgpack(payload, save_path)
    list_path = os.path.join(save_dir, MANIFEST)
    entries = [os.path.basename(save_path) + "\n"]
    if os.path.exists(list_path):
        with open(list_path) as fh:
            entries += fh.readlines()
    if max_keep is not None:
        for entry in entries[max_keep:]:
            stale = os.path.join(save_dir, entry.strip())
            if os.path.exists(stale):
                os.remove(stale)
        entries = entries[:max_keep]
    with open(list_path, "w") as fh:
        fh.writelines(entries)
    if is_best:
        shutil.copyfile(save_path, os.path.join(save_dir, "best_model.ckpt"))


def save_checkpoint(state, save_path: str, is_best: bool = False,
                    max_keep: Optional[int] = None) -> None:
    """Write ``state`` (a ``GanTrainState``) now."""
    write_checkpoint(trainer_payload(state), save_path, is_best, max_keep)


def _log_failure(future: Future) -> None:
    exc = future.exception()
    if exc is not None:
        print(f"[checkpoint] async save FAILED: {exc!r}", flush=True)


def save_checkpoint_async(state, save_path: str, is_best: bool = False,
                          max_keep: Optional[int] = None) -> Future:
    """Copy ``state`` to the host here, on the caller's thread, then write
    it on the writer thread; returns the Future (``.result()`` joins it).
    A failed write is logged when it happens."""
    future = _EXECUTOR.submit(write_checkpoint, trainer_payload(state),
                              save_path, is_best, max_keep)
    future.add_done_callback(_log_failure)
    return future
