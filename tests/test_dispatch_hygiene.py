"""Dispatch-path hygiene: no module-level jax.Array constants.

A jax.Array captured as a jit closure constant becomes a runtime argument
of every executable that uses it and takes the process off JAX's C++ fast
dispatch path (atracdenc_tpu/__init__.py).  Module tables must be host
numpy arrays, baked into the HLO as literals.

Two guards:
  * a source scan rejecting `NAME = jnp.<ctor>(...)` at module scope;
  * an import-time scan of every package module's globals for jax.Array
    values (catches constructions the regex can't see).
"""
import importlib
import pathlib
import pkgutil
import re

import jax
import numpy as np

import atracdenc_tpu

PKG_DIR = pathlib.Path(atracdenc_tpu.__file__).parent

_MODULE_LEVEL_JNP = re.compile(
    r"^_?[A-Za-z0-9_]+\s*=\s*jnp\.(asarray|array|arange|zeros|ones|full)\(",
    re.M)


def test_no_module_level_jnp_constants_in_source():
    bad = []
    for p in PKG_DIR.rglob("*.py"):
        for m in _MODULE_LEVEL_JNP.finditer(p.read_text()):
            bad.append(f"{p.relative_to(PKG_DIR)}: {m.group(0)}")
    assert not bad, (
        "module-level jax.Array constants become per-call arguments; "
        "use numpy (utils/npconst.py):\n" + "\n".join(bad))


def test_no_jax_arrays_in_module_globals():
    bad = []
    for info in pkgutil.walk_packages([str(PKG_DIR)],
                                      prefix="atracdenc_tpu."):
        if ".native" in info.name:
            continue
        try:
            mod = importlib.import_module(info.name)
        except Exception:
            continue                      # optional deps; other tests cover
        for name, val in vars(mod).items():
            if isinstance(val, jax.Array):
                bad.append(f"{info.name}.{name}")
    assert not bad, ("jax.Array module globals (per-call arguments; "
                     "use numpy): " + ", ".join(bad))


def test_np_canonicalizer():
    from atracdenc_tpu.utils.npconst import _npc
    assert _npc(np.arange(3)).dtype == np.int32
    assert _npc(np.arange(3.0)).dtype == np.float32
    assert _npc(np.arange(3, dtype=np.uint64)).dtype == np.uint32
    assert _npc(np.zeros(2, np.bool_)).dtype == np.bool_
    assert _npc(np.zeros(2, np.float32)).dtype == np.float32
