"""On-device MSB-first bitstream assembly.

The encoders' serialization used to be host-only (utils/bitpack.py + the
native C++ packer); for the batch-transcode pipeline that made device->host
transfer (full mantissa planes) plus single-core host packing the bottleneck.
This module assembles the final frame BYTES on the device:

Every field k of frame f deposits `widths[f,k]` bits of `values[f,k]` at the
absolute bit offset `offsets[f,k]` (MSB-first, fields non-overlapping, width
0 = absent).  Decomposition: a field spans at most two 32-bit words; its
contribution to each word is split into four byte lanes, and the scatter
"word w += contribution" is expressed as a one-hot [K, W] x [K, 4bytes]
matmul — exact integer arithmetic in a float contraction, because non-overlapping bit
fields make byte-lane sums equal to bitwise OR, each product is a 0/1 x
(0..255) byte, and f32 accumulation is exact far beyond those magnitudes.

This replaces bit-sequential packing with O(K*W) matmul work per frame and
leaves only container framing on the host.  (Reference semantics:
src/lib/bitstream/bitstream.cpp:40-91.)
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["deposit_fields"]


@partial(jax.jit, static_argnames=("total_bytes", "frame_chunk"))
def deposit_fields(values, widths, offsets, total_bytes, frame_chunk=32):
    """values/widths/offsets: [F, K] (uint32/int32/int32) -> [F, total_bytes]
    uint8 frames.  Fields must be pre-masked (only the low `widths` bits
    set), mutually non-overlapping, and fit in 24 bits / total_bytes*8."""
    f, k = values.shape
    n_words = (total_bytes + 3) // 4

    val = values.astype(jnp.uint32)
    w = widths.astype(jnp.int32)
    off = jnp.where(w > 0, offsets, 0).astype(jnp.int32)
    val = jnp.where(w > 0, val, 0)

    w0 = (off >> 5).astype(jnp.int32)                    # first word index
    r = (off & 31).astype(jnp.uint32)
    shift = 32 - w.astype(jnp.int32) - r.astype(jnp.int32)
    pos_s = jnp.maximum(shift, 0).astype(jnp.uint32)
    neg_s = jnp.maximum(-shift, 0).astype(jnp.uint32)
    hi = jnp.where(shift >= 0, val << pos_s, val >> neg_s)
    lo = jnp.where(shift < 0, val << (32 - neg_s), jnp.uint32(0))

    def bytes_of(x):
        return jnp.stack([(x >> 24) & 0xFF, (x >> 16) & 0xFF,
                          (x >> 8) & 0xFF, x & 0xFF], axis=-1)

    hib = bytes_of(hi).astype(jnp.bfloat16)              # [F, K, 4]
    lob = bytes_of(lo).astype(jnp.bfloat16)
    wgrid = jnp.arange(n_words, dtype=jnp.int32)

    def pack_chunk(args):
        w0c, hibc, lobc = args                           # [C, K], [C, K, 4]
        oh0 = (w0c[..., None] == wgrid).astype(jnp.bfloat16)      # [C, K, W]
        oh1 = ((w0c + 1)[..., None] == wgrid).astype(jnp.bfloat16)
        acc = jnp.einsum("ckw,ckp->cwp", oh0, hibc,
                         preferred_element_type=jnp.float32)
        acc += jnp.einsum("ckw,ckp->cwp", oh1, lobc,
                          preferred_element_type=jnp.float32)
        return acc.astype(jnp.uint8)                     # byte sums == OR

    pad_f = (-f) % frame_chunk
    w0p = jnp.pad(w0, ((0, pad_f), (0, 0)))
    hibp = jnp.pad(hib, ((0, pad_f), (0, 0), (0, 0)))
    lobp = jnp.pad(lob, ((0, pad_f), (0, 0), (0, 0)))
    nchunks = (f + pad_f) // frame_chunk
    shp = (nchunks, frame_chunk)
    out = jax.lax.map(pack_chunk, (w0p.reshape(shp + (k,)),
                                   hibp.reshape(shp + (k, 4)),
                                   lobp.reshape(shp + (k, 4))))
    bytes_all = out.reshape(nchunks * frame_chunk, n_words * 4)[:f]
    return bytes_all[:, :total_bytes]
