"""ATRAC3 rate control as a fixed-schedule vectorized search.

Reference behavior (src/atrac/at3/atrac3_bitstream.cpp:261-760 driven by the
src/lib/bs_encode/encode.cpp lambda bisection):

  per channel: lambda bisection over [-8, 20] (+-0.01 shrink); at each step
  CalcBitsAllocation -> per-BFU wordlens, then an inner fixed-point loop that
  quantizes each used BFU, measures the block energy error and bumps wordlens
  of the first 10 BFUs (ConsiderEnergyErr); the spectrum cost is
  min(CLC, VLC) + 3 bits/BFU + 6 bits/used BFU + tonal dry-run cost.  After
  convergence, a zero-allocated last BFU shrinks NumBfu by one and restarts
  the bisection (CheckBfus -> EStatus::Repeat).

Here the per-(bfu, wordlen) quantization results are materialized once as a
[..., 32, 8] cost tensor (the batched analog of TEncCache), so every bisection
step is a gather+sum batched over all frames and channels; the shrink rounds
run under one `lax.while_loop` that exits when no lane shrinks.
"""
import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from atracdenc_tpu.ops.quant import quant_blocks
from . import tables as T

_BISECT_STEPS = 11  # (28 / 2^k - 0.02) <= 0 at k = 11
_MAX_WL = 8

_ATH = _npc(np.asarray(T.ath_per_bfu(), jnp.float32))
_SPECS = _npc(np.asarray(T.SPECS_PER_BLOCK))
_FIX = _npc(np.asarray(T.FIXED_BIT_ALLOC.astype(np.float32)))
_XDIV = _npc(np.asarray(T.SFI_DIVISOR))
_BFU_BAND = _npc(np.asarray(T.BFU_TO_BAND))
_CLC_LEN = _npc(np.asarray(T.CLC_LENGTH_TAB))
_MAXQ = _npc(np.asarray(T.MAX_QUANT))
_VLC_BITS = _npc(np.asarray(T.VLC_BITS))
_VLC_PAIR_RTAB = _npc(np.asarray(T.VLC_PAIR_RTAB))
_IOTA32 = np.arange(T.MAX_BFUS, dtype=np.int32)


def _ea_groups():
    """EA-region BFU runs grouped by block length: [(b, e, len), ...]."""
    ea_lo = T.LOSY_NAQ_START + 1
    groups = []
    b = ea_lo
    while b < T.MAX_BFUS:
        ln = int(T.SPECS_PER_BLOCK[b])
        e = b
        while e < T.MAX_BFUS and int(T.SPECS_PER_BLOCK[e]) == ln:
            e += 1
        groups.append((b, e, ln))
        b = e
    return groups


def _plain_costs_xla(scaled, valid_mask):
    """XLA formulation: broadcast to 8 wordlen lanes, reduce."""
    from atracdenc_tpu.ops.quant import _round_energy

    x = scaled[..., :, None, :]                        # [..., 32, 1, 128]
    lanes = jnp.broadcast_to(x, x.shape[:-3] + (T.MAX_BFUS, _MAX_WL, 128))
    valid = valid_mask[:, None, :]
    mul = jnp.broadcast_to(_MAXQ, lanes.shape[:-1])
    mant, e1, e2 = _round_energy(lanes, valid, mul)
    err = e1 / e2

    # VLC cost (atrac3_bitstream.cpp:186-220) of the PLAIN-rounded
    # mantissas.  Table lookups are step-function arithmetic (codebook
    # lengths are grouped runs) instead of small-table gathers.
    vmask = valid_mask[:, :]                            # [32, 128]
    idx_single = jnp.where(mant < 0, (-mant) * 2,
                           jnp.where(mant > 0, mant * 2 - 1, 0))
    vlc_singles = []
    for w in range(_MAX_WL):
        sel = min(max(w - 1, 0), 6)
        bits = _vlc_bits_arith(idx_single[..., w, :], sel)  # [..., 32, 128]
        vlc_singles.append(jnp.sum(jnp.where(vmask, bits, 0), axis=-1))
    vlc_single = jnp.stack(vlc_singles, axis=-1)        # [..., 32, 8]
    return err, vlc_single, mant[..., 1, :]


def quant_tensors(scaled, valid_mask):
    """Per-(bfu, wordlen) quantization COSTS (the batched TEncCache).

    scaled: [..., 32, 128] scaled BFU values; valid_mask [32, 128] bool.
    Returns dict with
      err [..., 32, 8] (e1/e2), clc [..., 32, 8] int32 spectrum bits,
      vlc [..., 32, 8] int32.

    Mantissas are NOT materialized here (that memo was the largest tensor
    in the whole pipeline); `final_mantissas` recomputes them for the single
    chosen wordlen after allocation.  EA lanes contribute their VLC bit
    cost via per-flip deltas accumulated inside the greedy scan (exact,
    since single-symbol codes are independent); the wl==1 pair codebook is
    not flip-additive, so that one lane still runs in mantissa mode.
    """
    # CLC cost (atrac3_bitstream.cpp:163-184): wl>1 -> len*blockSize;
    # wl==1 -> 4*blockSize/2; wl==0 -> 0 (and never used).
    wl = np.arange(_MAX_WL)
    clc = jnp.asarray(np.where(wl[None, :] > 1,
                               _CLC_LEN[wl][None, :] * _SPECS[:, None],
                               _CLC_LEN[wl][None, :] * (_SPECS[:, None] // 2)))

    err, vlc_single, pair1 = _plain_costs_xla(scaled, valid_mask)
    clc = jnp.broadcast_to(clc, err.shape).astype(jnp.int32)

    x = scaled[..., :, None, :]                        # [..., 32, 1, 128]
    lanes = jnp.broadcast_to(x, x.shape[:-3] + (T.MAX_BFUS, _MAX_WL, 128))
    mul = jnp.broadcast_to(_MAXQ, lanes.shape[:-1])
    vmask = valid_mask[:, :]

    # EA pass per block-length group
    for b, e, ln in _ea_groups():
        sub = lanes[..., b:e, 1:, :ln]
        subv = valid_mask[b:e, None, :ln]
        subm = mul[..., b:e, 1:]
        ones = jnp.ones(subm.shape, bool)
        # wl==1 lane in mantissa mode (pair codes need the actual values)
        ea_m1, ea_e1 = quant_blocks(sub[..., 0, :], subv[:, 0],
                                    subm[..., 0], ones[..., 0])
        pair1 = pair1.at[..., b:e, :ln].set(ea_m1)
        err = err.at[..., b:e, 1].set(ea_e1)
        # wl 2..7 lanes in cost mode with single-symbol bit deltas;
        # per-candidate flipped mantissa (same formula as quant_blocks)
        t = sub * subm[..., None]
        m_old = jnp.round(t).astype(jnp.int32)
        m_old = jnp.where(subv, m_old, 0)
        m_up = jnp.where(m_old > 0, m_old + 1,
                         jnp.where(m_old < 0, m_old - 1,
                                   jnp.where(t > 0, 1, -1)))
        m_dn = jnp.where(m_old > 0, m_old - 1,
                         jnp.where(m_old < 0, m_old + 1, m_old))
        # e1/e2 exactly as ops.quant._round_energy computes them (same op
        # order incl. the reciprocal form) so the up/dn branch below always
        # matches the one quant_blocks picks internally
        e2g = jnp.sum(jnp.where(subv, (m_old * m_old).astype(sub.dtype),
                                0.0), axis=-1) * (1.0 / (subm * subm))
        e1g = jnp.sum(jnp.where(subv, sub * sub, 0.0), axis=-1)
        up_branch = (e2g < e1g)[..., None]
        m_new = jnp.where(up_branch, m_up, m_dn)
        dbits = jnp.zeros(m_old.shape, jnp.int32)
        for w in range(2, _MAX_WL):
            sel = min(w - 1, 6)
            d = (_vlc_bits_arith(_vlc_idx_of(m_new[..., w - 1, :]), sel)
                 - _vlc_bits_arith(_vlc_idx_of(m_old[..., w - 1, :]), sel))
            dbits = dbits.at[..., w - 1, :].set(d)
        ea_err, ea_db = quant_blocks(sub[..., 1:, :], subv[:, :1],
                                     subm[..., 1:], ones[..., 1:],
                                     aux=dbits[..., 1:, :])
        err = err.at[..., b:e, 2:].set(ea_err)
        vlc_single = vlc_single.at[..., b:e, 2:].add(ea_db)

    # wl==1 pairs: 9-entry map (a+1)*3+(b+1) -> table-1 index, as selects
    pairs = pair1.reshape(pair1.shape[:-1] + (64, 2))
    key = 3 * (pairs[..., 0] + 1) + (pairs[..., 1] + 1)
    bits_pair = sum(int(T.VLC_BITS[0, T.VLC_PAIR_RTAB[k]]) * (key == k)
                    for k in range(9))
    pair_valid = vmask.reshape(32, 64, 2)[..., 0]
    vlc_pair = jnp.sum(jnp.where(pair_valid, bits_pair, 0), axis=-1)

    vlc = vlc_single.at[..., 1].set(vlc_pair).astype(jnp.int32)
    # Non-finite err lanes poison _energy_boost's one-hot selection of
    # OTHER lanes (inf*0 and nan*0 are nan).  Map them to select-safe
    # finite values that make the SAME ConsiderEnergyErr decisions as the
    # reference's float arithmetic: NaN (wl==0: 0*inf; silent block: 0/0)
    # -> 0 (every comparison false, like NaN), +inf (all-zero mantissas at
    # mul>0) -> FLT_MAX (still boosts via err > 1.2).
    err = jnp.where(jnp.isnan(err), 0.0,
                    jnp.where(jnp.isinf(err), jnp.finfo(jnp.float32).max,
                              err))
    return {"err": err, "clc": clc, "vlc": vlc}


def _vlc_idx_of(m):
    return jnp.where(m < 0, (-m) * 2, jnp.where(m > 0, m * 2 - 1, 0))


def final_mantissas(scaled, valid_mask, wl):
    """Recompute mantissas for the CHOSEN wordlens only.

    scaled [..., 32, 128], valid_mask [32, 128], wl [..., 32] int.
    Returns mant [..., 32, 128] int8 — bit-identical to selecting the
    chosen-wl lane of the old full memo (same ops at the same values).
    """
    from atracdenc_tpu.ops.quant import _round_energy

    mul = onehot_select(jnp.broadcast_to(_MAXQ, wl.shape + (_MAX_WL,)), wl)
    mant, _, _ = _round_energy(scaled, valid_mask, mul)
    for b, e, ln in _ea_groups():
        ea_m, _ = quant_blocks(scaled[..., b:e, :ln], valid_mask[b:e, :ln],
                               mul[..., b:e],
                               jnp.ones(mul[..., b:e].shape, bool))
        mant = mant.at[..., b:e, :ln].set(ea_m)
    return mant.astype(jnp.int8)


def _vlc_bits_arith(idx, sel):
    """Bit-length of symbol `idx` in spectrum codebook `sel`, as a sum of
    step functions derived from the table (lengths are short runs)."""
    lens = T.VLC_BITS[sel]
    out = jnp.full(idx.shape, int(lens[0]), jnp.int32)
    prev = int(lens[0])
    for j in range(1, 63):
        if lens[j] == 0:
            break
        d = int(lens[j]) - prev
        if d:
            out = out + d * (idx >= j)
        prev = int(lens[j])
    return out


def onehot_select(table, idx):
    """table [..., K], idx [...] -> table[..., idx] via one-hot contraction
    instead of a small-axis take_along_axis."""
    k = table.shape[-1]
    oh = jax.nn.one_hot(idx, k, dtype=table.dtype)
    return jnp.sum(table * oh, axis=-1)


def csfi_gated(sfi, gain_scale_frame, energy, loudness):
    """Lambda-independent allocation inputs: the gain-energy-corrected SFI
    (csfi) and the ATH x loudness gate (atrac3_bitstream.cpp:343-371)."""
    band_oh = jnp.asarray(
        np.eye(4, dtype=np.float32)[T.BFU_TO_BAND].T)   # [4, 32] static
    # HIGHEST: a TF32 product would round the scale before the log2 below
    # and move csfi; a non-finite band poisons every BFU (inf * 0), which
    # the sanitize below maps to 1.0
    gs = jnp.einsum("...b,bk->...k", gain_scale_frame, band_oh,
                    precision=jax.lax.Precision.HIGHEST)
    gs = jnp.where(jnp.isfinite(gs) & (gs > 0), gs, 1.0)

    corrected_energy = energy * gs
    gated = corrected_energy < _ATH * loudness[..., None]
    csfi = jnp.clip(sfi.astype(jnp.float32) + 1.5 * jnp.log2(gs), 0.0, 63.0)
    return csfi, gated


def calc_bits_allocation(sfi, gain_scale_frame, energy, spread, shift,
                         num_bfu, loudness, tonal_bfu_counts):
    """Vectorized CalcBitsAllocation (atrac3_bitstream.cpp:343-407).

    sfi [..., 32] int, gain_scale_frame [..., 4], energy [..., 32],
    spread [...], shift [...], num_bfu [...], loudness [...],
    tonal_bfu_counts [..., 32] int (number of tonal blocks per BFU).
    Returns wordlens [..., 32] int32 (zero beyond num_bfu).
    """
    in_use = _IOTA32 < num_bfu[..., None]
    csfi, gated = csfi_gated(sfi, gain_scale_frame, energy, loudness)
    tmp = jnp.trunc(spread[..., None] * (csfi / _XDIV)
                    + (1.0 - spread[..., None]) * _FIX - shift[..., None])
    wl = jnp.where(tmp > 7, 7,
                   jnp.where(tmp < 0, 0,
                             jnp.where(tmp == 0, 1, tmp))).astype(jnp.int32)
    wl = jnp.where(gated | ~in_use, 0, wl)

    # tonal discount: one -1 per tonal block mapped to a used BFU while wl>2
    # (atrac3_bitstream.cpp:396-404; counts>1 keep decrementing)
    def discount(_, w):
        return jnp.where(in_use & (tonal_bfu_counts > _) & (w > 2), w - 1, w)
    max_tc = 3  # a BFU spans <=5-coef runs; more than 3 hits cannot lower wl further
    wl = jax.lax.fori_loop(0, max_tc, discount, wl)
    return wl


def _spec_cost(wl, qt, num_bfu):
    """(coding_mode [...], bits [...]) for a given allocation
    (CalcSpecsBitsConsumption, atrac3_bitstream.cpp:261-298)."""
    in_use = (_IOTA32 < num_bfu[..., None]) & (wl > 0)
    clc = onehot_select(qt["clc"].astype(jnp.float32), wl).astype(jnp.int32)
    vlc = onehot_select(qt["vlc"].astype(jnp.float32), wl).astype(jnp.int32)
    clc_sum = jnp.sum(jnp.where(in_use, clc, 0), axis=-1)
    vlc_sum = jnp.sum(jnp.where(in_use, vlc, 0), axis=-1)
    mode = clc_sum <= vlc_sum          # 1 = CLC
    bits = (3 * num_bfu + 6 * jnp.sum(in_use, axis=-1)
            + jnp.where(mode, clc_sum, vlc_sum))
    return mode, bits


def _energy_boost(wl, qt, num_bfu):
    """Fixed-point ConsiderEnergyErr loop (atrac3_bitstream.cpp:312-328,
    709-712): bump wordlens of the first 10 BFUs while the per-block energy
    ratio is off, until no lane adjusts."""
    boostable = _IOTA32 < jnp.minimum(T.BOOST_NAQ_END, num_bfu)[..., None]

    def body(state):
        w, _ = state
        err = onehot_select(qt["err"], w)
        e = jnp.where(w > 0, err, 0.0)
        cond = (((e > 0) & (e < 0.7)) | (e > 1.2)) & (w < 7) & boostable
        return jnp.where(cond, w + 1, w), jnp.any(cond)

    def cond(state):
        return state[1]

    w, _ = jax.lax.while_loop(cond, body, body((wl, True)))
    return w


def _bisect(sfi, gain_scale, energy, spread, num_bfu, loudness,
            tonal_counts, tonal_bits_fn, qt, target):
    """One full lambda bisection at a given num_bfu; returns final wordlens
    (energy-boosted) evaluated at the best under-budget lambda."""
    shape = num_bfu.shape
    min_l = jnp.full(shape, -8.0, jnp.float32)
    max_l = jnp.full(shape, 20.0, jnp.float32)
    last_l = jnp.full(shape, 20.0, jnp.float32)

    def eval_alloc(shift):
        wl = calc_bits_allocation(sfi, gain_scale, energy, spread, shift,
                                  num_bfu, loudness, tonal_counts)
        wl = _energy_boost(wl, qt, num_bfu)
        _, bits = _spec_cost(wl, qt, num_bfu)
        return wl, bits + tonal_bits_fn(wl, num_bfu)

    def step(_, carry):
        min_l, max_l, last_l = carry
        active = max_l > min_l
        cur = (max_l + min_l) * 0.5
        _, bits = eval_alloc(cur)
        under = bits < target
        over = bits > target
        exact = ~under & ~over
        last_l = jnp.where(active & (under | exact), cur, last_l)
        max_l = jnp.where(active & under, cur - 0.01, max_l)
        min_l = jnp.where(active & over, cur + 0.01, min_l)
        max_l = jnp.where(active & exact, min_l, max_l)
        return min_l, max_l, last_l

    min_l, max_l, last_l = jax.lax.fori_loop(
        0, _BISECT_STEPS, step, (min_l, max_l, last_l))
    wl, _ = eval_alloc(last_l)
    return wl


def allocate(qt, sfi, gain_scale, energy, spread, loudness,
             target_bits, tonal_counts=None, tonal_bits_fn=None,
             bfu_idx_const=0):
    """Full rate control for a batch of channel-frames.

    qt: precomputed quant tensors (see quant_tensors).
    sfi [..., 32], gain_scale [..., 4] (frame energy scale per band),
    energy [..., 32], spread [...], loudness [...] (Loudness/LoudFactor),
    target_bits [...] int32.
    tonal_bits_fn(wl) -> [...] tonal section cost for an allocation
    (defaults to the constant 5-bit empty-tonal header).
    Returns (num_bfu [...], coding_mode [...] bool (1=CLC), wordlen [..., 32]).
    """
    if tonal_counts is None:
        tonal_counts = jnp.zeros(sfi.shape, jnp.int32)
    if tonal_bits_fn is None:
        tonal_bits_fn = lambda wl, num_bfu: jnp.asarray(5, jnp.int32)

    init = bfu_idx_const if bfu_idx_const else 32
    lim = jnp.where(target_bits > 5,
                    jnp.maximum(1, (target_bits - 5) // 3), 1)
    num_bfu = jnp.where(target_bits < 101,
                        jnp.minimum(init, lim),
                        jnp.asarray(init)).astype(jnp.int32)
    num_bfu = jnp.maximum(num_bfu, 1)

    def run_bisect(num_bfu):
        return _bisect(sfi, gain_scale, energy, spread, num_bfu,
                       loudness, tonal_counts, tonal_bits_fn, qt,
                       target_bits)

    def one_round(num_bfu):
        wl = run_bisect(num_bfu)
        last = jnp.take_along_axis(wl, (num_bfu - 1)[..., None],
                                   axis=-1)[..., 0]
        shrink = (last == 0) & (num_bfu > 1) & (bfu_idx_const == 0)
        return wl, shrink

    def body(state):
        num_bfu, _, _ = state
        wl, shrink = one_round(num_bfu)
        return jnp.where(shrink, num_bfu - 1, num_bfu), wl, shrink

    def cond(state):
        return jnp.any(state[2])

    wl0, shrink0 = one_round(num_bfu)
    state = (jnp.where(shrink0, num_bfu - 1, num_bfu), wl0, shrink0)
    num_bfu, wl, _ = jax.lax.while_loop(cond, body, state)

    mode, _ = _spec_cost(wl, qt, num_bfu)
    return num_bfu, mode, wl
