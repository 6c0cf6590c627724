"""Module-level table constants must stay HOST numpy arrays.

numpy closure constants are baked into the HLO as literals, at no
per-call cost.  A jax.Array captured as a jit closure constant is hoisted
into a runtime argument of the executable instead: it is passed on every
call, and it takes the process off JAX's C++ fast dispatch path.

`_npc` canonicalizes dtypes the way `jnp.asarray` would (int64 -> int32,
float64 -> float32, uint64 -> uint32) so swapping jnp constants for np
constants never changes the traced program's dtypes.
"""
import numpy as np

_CANON = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32,
          np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}


def _npc(a):
    a = np.asarray(a)
    tgt = _CANON.get(a.dtype)
    return a.astype(tgt) if tgt is not None else a
