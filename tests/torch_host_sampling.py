"""Like against like in the loader parity tests: the port's host sampling
on its plain versions beside the JAX package's numpy / scipy path, or the
port's native library beside the JAX package's.

Both packages take their native library for FPS and the patch search; the
JAX package falls back to numpy / scipy when ``native.available()`` is
false, and the port's plain versions (``data/sampling.py : PLAIN``) are
that fallback's code. The two libraries are one source
built with one compiler and one set of flags, so they agree bit for bit;
the library and the plain versions may not (the library's squared
distances round as its compiler contracts them).
"""

import pytest

import tpugan_tpu.data.native as jax_native
from tpugan_tpu_torch.data import native as tnative
from tpugan_tpu_torch.data import sampling as tsampling

MODES = ["plain", "native"]


def host_sampling(monkeypatch, mode: str) -> None:
    """Put both packages' loaders on ``mode``'s path: "plain" (the JAX
    package's numpy / scipy fallback, the port's plain versions) or
    "native" (both libraries; skips where the JAX package's library is not
    built)."""
    if mode == "plain":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        for name, plain in tsampling.PLAIN.items():
            monkeypatch.setattr(tnative, name, plain)
    elif not jax_native.available():
        pytest.skip("the JAX package's native library is not built")
