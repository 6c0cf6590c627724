"""MDCT / IMDCT as matmuls.

The reference computes the MDCT with a pre-twiddle + complex FFT(N/4) +
post-twiddle pipeline (reference: src/lib/mdct/mdct.h:51-178).  At the
transform sizes in play (N <= 512) a direct ``[N, N/2]`` matmul is the
simplest and most numerically robust formulation: it is a single matmul,
batches trivially over thousands of frames, and has no FFT bit-reversal
shuffles that fight the vector unit.

Conventions (verified numerically against the reference implementation):

* ``TMDCT<N>(scale)``  ==  ``(scale / N) * direct_mdct`` where
  ``direct_mdct[k] = sum_n x[n] * cos(2*pi/N * (n + 0.5 + N/4) * (k + 0.5))``
* ``TMIDCT<N>(scale=2N)``  ==  ``2 * direct_imdct`` where
  ``direct_imdct[n] = sum_k X[k] * cos(2*pi/N * (n + 0.5 + N/4) * (k + 0.5))``

(reference: src/lib/mdct/mdct.cpp:25-36 folds sqrt(scale/N) into each of the
two twiddle passes, so the net factor is scale/N; the IMDCT kernel carries an
explicit extra factor of 2 — mdct.h:138.)
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["mdct_matrix", "mdct", "imdct"]


@lru_cache(maxsize=None)
def _mdct_matrix_np(n: int) -> np.ndarray:
    """Direct MDCT basis, shape [N/2, N], float64."""
    m = np.arange(n, dtype=np.float64)
    k = np.arange(n // 2, dtype=np.float64)
    return np.cos(2.0 * np.pi / n * np.outer(k + 0.5, m + 0.5 + n / 4.0))


def mdct_matrix(n: int, scale: float = 1.0, dtype=jnp.float32) -> jax.Array:
    """[N/2, N] MDCT basis scaled by `scale` (built in f64, cast to `dtype`)."""
    return jnp.asarray(_mdct_matrix_np(n) * scale, dtype=dtype)


def mdct(x: jax.Array, scale: float = 1.0) -> jax.Array:
    """Forward MDCT over the last axis: [..., N] -> [..., N/2].

    `scale` is the overall output scaling (e.g. the reference's AT1 long MDCT
    uses scale = 1/512 relative to the direct formula).
    """
    n = x.shape[-1]
    basis = mdct_matrix(n, scale, x.dtype)
    return jax.lax.dot_general(
        x, basis,
        dimension_numbers=(((x.ndim - 1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=x.dtype,
    )


def imdct(spec: jax.Array, scale: float = 2.0) -> jax.Array:
    """Inverse MDCT over the last axis: [..., N/2] -> [..., N].

    With the default ``scale=2.0`` this matches the reference's
    ``TMIDCT<N>(2N)`` instances used by every codec (atrac1denc.h:52-54).
    """
    n = 2 * spec.shape[-1]
    basis = mdct_matrix(n, scale, spec.dtype)  # [N/2, N]
    return jax.lax.dot_general(
        spec, basis,
        dimension_numbers=(((spec.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=spec.dtype,
    )
