"""Spectrum <-> padded-BFU-block reshaping via static slices.

The 32 BFUs tile the 1024-line spectrum with contiguous ranges
(BLOCK_SIZE_TAB boundaries, reference atrac3.h:79-110), so the
[..., 32, 128] zero-padded block view is a static slice/pad composition —
NOT a gather: these compile to plain copies.
"""
import jax.numpy as jnp

from . import tables as T


def to_blocks(specs):
    """[..., 1024] -> [..., 32, 128] (zero-padded per BFU)."""
    parts = []
    for b in range(32):
        s = int(T.SPECS_START[b])
        ln = int(T.SPECS_PER_BLOCK[b])
        parts.append(jnp.pad(specs[..., s:s + ln],
                             [(0, 0)] * (specs.ndim - 1) + [(0, 128 - ln)]))
    return jnp.stack(parts, axis=-2)


def from_blocks(blocks):
    """[..., 32, 128] -> [..., 1024] (inverse of to_blocks)."""
    parts = []
    for b in range(32):
        ln = int(T.SPECS_PER_BLOCK[b])
        parts.append(blocks[..., b, :ln])
    return jnp.concatenate(parts, axis=-1)
