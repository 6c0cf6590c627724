"""Block-floating scaler: per-BFU scale-factor search + mantissa quantization.

Batched reformulation of the reference's per-block scaler (reference:
src/atrac/atrac_scale.cpp:134-188): the std::map lower_bound over the 64-entry
scale table becomes a `searchsorted` against the same float32 table, so the
chosen indices match the reference exactly.
"""
import jax
import jax.numpy as jnp

__all__ = ["scale_blocks", "quant_mantissas"]


def scale_blocks(values, valid_mask, scale_table):
    """Scale padded BFU blocks.

    values:     [..., n_bfu, maxlen] spectral lines gathered per BFU
    valid_mask: [n_bfu, maxlen] bool — real lines (padding is zero)
    scale_table: [64] float32 ascending

    Returns (sfi [..., n_bfu] int32, scaled [..., n_bfu, maxlen], energy
    [..., n_bfu]).  Scaled values are clipped to +/-0.99999 like the
    reference (atrac_scale.cpp:163-168); max|spec| is clamped to 1.0.
    """
    absx = jnp.abs(values) * valid_mask
    maxabs = jnp.minimum(jnp.max(absx, axis=-1), 1.0)
    # lower_bound as a comparison count (exact, and one fused reduction
    # instead of searchsorted's gather-based binary search)
    sfi = jnp.sum(scale_table[:-1] < maxabs[..., None],
                  axis=-1).astype(jnp.int32)
    oh = jax.nn.one_hot(sfi, scale_table.shape[0], dtype=scale_table.dtype)
    sf = jnp.sum(oh * scale_table, axis=-1)
    scaled = values / sf[..., None]
    clipped = jnp.clip(scaled, -0.99999, 0.99999)
    scaled = jnp.where(jnp.abs(scaled) >= 1.0, clipped, scaled)
    energy = jnp.sum(values * values * valid_mask, axis=-1)
    return sfi, scaled * valid_mask, energy


def quant_mantissas(scaled, wordlen):
    """Round-half-even mantissa quantization (ToInt/lrint under FE_TONEAREST,
    reference: src/util.h:98-109, atrac1_bitalloc.cpp:307-317).

    scaled:  [..., n_bfu, maxlen] in (-1, 1)
    wordlen: [..., n_bfu] int — 0/2..16
    Returns int32 mantissas (zero where wordlen < 2).
    """
    multiple = (jnp.left_shift(1, jnp.maximum(wordlen, 1) - 1) - 1).astype(scaled.dtype)
    mant = jnp.round(scaled * multiple[..., None]).astype(jnp.int32)
    return jnp.where((wordlen >= 2)[..., None], mant, 0)
