"""ATRAC1 bit allocation as a fixed-iteration vectorized search.

The reference's rate control is a per-frame lambda bisection driven through a
part-encoder pipeline with Repeat semantics (reference:
src/lib/bs_encode/encode.cpp:57-129, src/atrac/at1/atrac1_bitalloc.cpp).
Iteration counts are data-independent in the worst case, so here every frame
runs the same fixed schedule — K bisection steps per round, up to 8
BFU-shrink rounds, then the leftover-bit booster — with converged lanes
masked, batched over all frames of all channels at once.
"""
import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from atracdenc_tpu.ops import psy
from . import tables as T

# Enough bisection steps to guarantee max<=min for the [-3,15] interval with
# the +-0.01 shrink (width w_k = 18.02/2^k - 0.02 <= 0 at k=10).
_BISECT_STEPS = 11
_SHRINK_ROUNDS = 8

# Per-BFU ATH floor: min ATH power over each BFU's long-window lines
# (atrac1_bitalloc.cpp:118-135).
def _at1_ath_long() -> np.ndarray:
    ath_spec = psy.calc_ath(512, 44100)
    out = np.empty(T.MAX_BFUS, dtype=np.float64)
    for b in range(T.MAX_BFUS):
        s = T.SPECS_START_LONG[b]
        n = T.SPECS_PER_BLOCK[b]
        out[b] = 10.0 ** (0.1 * ath_spec[s: s + n].min())
    return out


_ATH_LONG = _npc(np.asarray(_at1_ath_long(), jnp.float32))
_SPECS_PER_BLOCK = _npc(np.asarray(T.SPECS_PER_BLOCK))
_FIX_LONG = _npc(np.asarray(T.FIXED_BIT_ALLOC_LONG))
_FIX_SHORT = _npc(np.asarray(T.FIXED_BIT_ALLOC_SHORT))
_BFU_TO_BAND = _npc(np.asarray(T.BFU_TO_BAND))
_BFU_AMOUNT = _npc(np.asarray(T.BFU_AMOUNT_TAB))
_IOTA52 = np.arange(T.MAX_BFUS, dtype=np.int32)

# Boost walk order: (bits, position) sorted by bits then position
# (multimap construction in atrac1_bitalloc.cpp:69-78).
_BOOST_ENTRIES = sorted(
    (int(T.SPECS_PER_BLOCK[i]), i)
    for i in range(T.MAX_BFUS) if T.BIT_BOOST_MASK[i]
)
_BOOST_MIN_KEY = _BOOST_ENTRIES[0][0]
_BOOST_MAX_PER_IT = _BOOST_ENTRIES[-1][0]


def _avail_bits(bfu_num):
    return (T.SOUND_UNIT_SIZE * 8 - T.BITS_PER_BFU_AMOUNT_TAB_IDX - 32 - 2 - 3
            - bfu_num * (T.BITS_PER_IDWL + T.BITS_PER_IDSF))


def calc_bits_allocation(sfi, energy, short_flags, loudness, shift, bfu_num):
    """Vectorized CalcBitsAllocation (atrac1_bitalloc.cpp:163-205).

    sfi [..., 52] int, energy [..., 52], short_flags [..., 3] bool,
    loudness [...] (already divided by LoudFactor), shift [...], bfu_num [...].
    Returns word lengths [..., 52] int32 (zeros beyond bfu_num).
    """
    in_use = _IOTA52 < bfu_num[..., None]
    band = _BFU_TO_BAND
    short_per_bfu = jnp.take_along_axis(
        short_flags, jnp.broadcast_to(band, sfi.shape), axis=-1)

    # low->mid tilt (atrac1_bitalloc.cpp:147-161); in_use always covers the
    # 20 low BFUs; mid count varies with bfu_num.
    is_low = (band == 0) & in_use
    is_mid = (band == 1) & in_use
    n_low = jnp.sum(is_low, axis=-1)
    n_mid = jnp.sum(is_mid, axis=-1)
    sum_low = jnp.sum(jnp.where(is_low, sfi, 0), axis=-1).astype(jnp.float32)
    sum_mid = jnp.sum(jnp.where(is_mid, sfi, 0), axis=-1).astype(jnp.float32)
    tilt = jnp.where((n_low > 0) & (n_mid > 0),
                     sum_low / jnp.maximum(n_low, 1) - sum_mid / jnp.maximum(n_mid, 1),
                     0.0)
    mid_bias = jnp.minimum(T.BAND_BIAS_MAX,
                           T.BAND_BIAS_GAIN * jnp.maximum(0.0, tilt - T.BAND_BIAS_TILT_FLOOR))
    band_bias = jnp.stack([jnp.zeros_like(mid_bias), mid_bias,
                           mid_bias * T.BAND_BIAS_HIGH_RATIO], axis=-1)
    bias_per_bfu = jnp.take_along_axis(
        band_bias, jnp.broadcast_to(band, sfi.shape), axis=-1)

    fix = jnp.where(short_per_bfu, _FIX_SHORT, _FIX_LONG)
    ath = _ATH_LONG * loudness[..., None]
    gated = (~short_per_bfu) & (energy < ath)

    spread = T.BIT_ALLOC_SPREAD
    tmp = (spread * (sfi.astype(jnp.float32) / 3.2)
           + (1.0 - spread) * fix - shift[..., None] + bias_per_bfu)
    tmp = jnp.trunc(tmp)  # C int cast truncates toward zero
    wl = jnp.where(tmp > 16, 16, jnp.where(tmp < 2, 0, tmp)).astype(jnp.int32)
    wl = jnp.where(gated | ~in_use, 0, wl)
    return wl


def _bits_used(wl, bfu_num):
    in_use = _IOTA52 < bfu_num[..., None]
    return jnp.sum(jnp.where(in_use, _SPECS_PER_BLOCK * wl, 0), axis=-1)


def _bisect(sfi, energy, short_flags, loudness, bfu_num):
    """Fixed-step lambda bisection (encode.cpp:57-98). Returns final wl."""
    target = _avail_bits(bfu_num)
    min_l = jnp.full(bfu_num.shape, -3.0, jnp.float32)
    max_l = jnp.full(bfu_num.shape, 15.0, jnp.float32)
    last_l = jnp.full(bfu_num.shape, 15.0, jnp.float32)

    def step(_, carry):
        min_l, max_l, last_l = carry
        active = max_l > min_l
        cur = (max_l + min_l) * 0.5
        wl = calc_bits_allocation(sfi, energy, short_flags, loudness, cur, bfu_num)
        bits = _bits_used(wl, bfu_num)
        under = bits < target
        over = bits > target
        exact = ~under & ~over
        last_l = jnp.where(active & (under | exact), cur, last_l)
        max_l = jnp.where(active & under, cur - 0.01, max_l)
        min_l = jnp.where(active & over, cur + 0.01, min_l)
        # an exact hit ends the search: collapse the interval
        max_l = jnp.where(active & exact, min_l, max_l)
        return min_l, max_l, last_l

    min_l, max_l, last_l = jax.lax.fori_loop(
        0, _BISECT_STEPS, step, (min_l, max_l, last_l))
    return calc_bits_allocation(sfi, energy, short_flags, loudness, last_l, bfu_num)


def _apply_boost(wl, bfu_num):
    """Spend leftover bits on whitelisted BFUs (atrac1_bitalloc.cpp:80-114)."""
    target = _avail_bits(bfu_num)
    surplus = (target - _bits_used(wl, bfu_num)).astype(jnp.int32)
    key = jnp.minimum(surplus, _BOOST_MAX_PER_IT)
    # frames whose initial surplus is below every entry never boost
    enabled = surplus >= _BOOST_MIN_KEY

    def one_pass(state):
        wl, surplus, _ = state
        changed = jnp.zeros(surplus.shape, bool)
        for bits, pos in _BOOST_ENTRIES:
            w = wl[..., pos]
            nbps = jnp.where(w > 0, 1, 2)
            ok = (enabled
                  & (surplus >= _BOOST_MIN_KEY)
                  & (bits <= key)                      # maxIt bound (initial surplus)
                  & (pos < bfu_num)                    # `break` on first OOR pos:
                  & (w != 16)
                  & ~((w == 0) & (bits * 2 > surplus))
                  & (bits * nbps <= surplus))
            # NOTE: the reference `break`s the pass when pos >= bfuNum; since
            # positions are visited in increasing order within equal keys and
            # keys only grow, every later entry has pos>=bfu_num or a larger
            # key — a plain mask is equivalent for this table (positions are
            # monotonically increasing in walk order).
            inc = jnp.where(ok, nbps, 0)
            wl = wl.at[..., pos].add(inc)
            surplus = surplus - inc * bits
            changed = changed | ok
        return wl, surplus, changed

    def cond(state):
        _, surplus, changed = state
        return jnp.any(changed & (surplus >= _BOOST_MIN_KEY))

    init = one_pass((wl, surplus, jnp.zeros(surplus.shape, bool)))
    wl, surplus, _ = jax.lax.while_loop(cond, lambda s: one_pass(s), init)
    return wl


def allocate(sfi, energy, short_flags, loudness, bfu_idx_const=0):
    """Full rate control for a batch of frames.

    sfi [..., 52], energy [..., 52], short_flags [..., 3] bool,
    loudness [...] (Loudness / LoudFactor).
    Returns (bfu_idx [...] int32, wordlen [..., 52] int32).
    """
    auto = bfu_idx_const == 0
    start_idx = 7 if auto else bfu_idx_const - 1
    bfu_idx = jnp.full(loudness.shape, start_idx, jnp.int32)

    bfu_amount = jnp.asarray(_BFU_AMOUNT)      # np const: tracer indexing
    wl = _bisect(sfi, energy, short_flags, loudness, bfu_amount[bfu_idx])
    if auto:
        def round_fn(_, carry):
            bfu_idx, wl = carry
            bfu_num = bfu_amount[bfu_idx]
            last_nz = jnp.max(jnp.where((wl > 0) & (_IOTA52 < bfu_num[..., None]),
                                        _IOTA52, -1), axis=-1)
            # lower_bound over the 8-entry table as a comparison count
            # (XLA searchsorted lowers to slow per-lane binary search)
            used_idx = jnp.sum(
                jnp.asarray(T.BFU_AMOUNT_TAB)[None, :]
                < (last_nz + 1)[..., None], axis=-1).astype(jnp.int32)
            repeat = used_idx < bfu_idx
            new_idx = jnp.where(repeat, bfu_idx - 1, bfu_idx)
            new_wl = _bisect(sfi, energy, short_flags, loudness,
                             bfu_amount[new_idx])
            wl = jnp.where(repeat[..., None], new_wl, wl)
            return new_idx, wl

        bfu_idx, wl = jax.lax.fori_loop(0, _SHRINK_ROUNDS - 1, round_fn,
                                        (bfu_idx, wl))

    wl = _apply_boost(wl, bfu_amount[bfu_idx])
    return bfu_idx, wl
