"""ATRAC3 tonal components: extraction, rate-control cost, serialization.

Reference behavior:
  * spectral flatness per BFU gates extraction (atrac_psy_common.cpp:158-199,
    threshold 0.01 in atrac3denc.cpp:585);
  * per gated BFU in [8, 29) the best run of <=5 coefficients by cumulative
    |spec| is lifted out of the spectrum (ExtractTonalComponents,
    atrac3denc.cpp:581-643) and scaled as its own block
    (MapTonalComponents, :646-662) — runs are <=5 < 7, so each tonal BFU
    yields exactly one coded group;
  * during rate control the tonal section is costed per candidate allocation
    (quantizer = clamp(alloc[bfu]+4, 2, 7)), with groups bucketed by
    (quantizer, length) and split into subgroups by the 64-line-window
    "limiter" walk (GroupTonalComponents/EncodeTonalComponents,
    atrac3_bitstream.cpp:409-595).

Extraction is fully batched; the subgroup walk is a 32-step `lax.scan`
vectorized over the 42 (quantizer, length) buckets and all frames at once.
"""
import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from atracdenc_tpu.ops import scale as scale_ops
from . import specblocks
from . import tables as T

FLATNESS_THRESHOLD = 0.01
MAX_TONAL_LEN = 5
TONAL_BFU_FIRST = 8
TONAL_BFU_LAST = 29          # exclusive
_VLC_BITS = _npc(np.asarray(T.VLC_BITS))
_IOTA32 = np.arange(32, dtype=np.int32)


def flatness_per_bfu(mdct_energy, energy_floor=1e-12):
    """[..., 1024] per-line energies -> [..., 32] geometric/arithmetic-mean
    ratios (CalcSpectralFlatnessPerBfu)."""
    vals = specblocks.to_blocks(mdct_energy)
    mask = jnp.asarray(T.GATHER_MASK)
    floor = max(energy_floor, 1e-20)
    e = jnp.maximum(vals, 0.0)
    n = jnp.asarray(T.SPECS_PER_BLOCK, jnp.float32)
    arith = jnp.sum(jnp.where(mask, e, 0.0), axis=-1) / n
    mean_log = jnp.sum(jnp.where(mask, jnp.log(jnp.maximum(e, floor)), 0.0),
                       axis=-1) / n
    geom = jnp.exp(mean_log)
    ratio = jnp.clip(geom / arith, 0.0, 1.0)
    return jnp.where(arith <= floor, 1.0, ratio)


def extract(specs, flatness):
    """Lift the best tonal run out of each gated BFU.

    specs [..., 1024], flatness [..., 32].
    Returns (specs_out, planes) where planes holds per-BFU group data:
      active [..., 32] bool, start [..., 32] (absolute line), len [..., 32],
      values [..., 32, 5] (raw spec values; zero beyond len).
    """
    gate = (flatness < FLATNESS_THRESHOLD) \
        & (_IOTA32 >= TONAL_BFU_FIRST) & (_IOTA32 < TONAL_BFU_LAST)

    blocks = specblocks.to_blocks(specs)
    absb = jnp.abs(blocks) * jnp.asarray(T.GATHER_MASK)

    # score[start, len] = sum_{k < len} |spec[start+k]| via shifted cumsums;
    # out-of-block candidates are invalid.  C picks the first strictly-
    # greater candidate in (start asc, len asc) order (atrac3denc.cpp:
    # 610-621).  |spec| >= 0 makes score NONDECREASING in len, so the
    # selection collapses to one reduction: per start, the max-over-len is
    # the full-length score (len capped at the block end) and the chosen
    # len is the smallest achieving it — i.e. last nonzero |spec| in the
    # window; across starts, argmax's first-max rule IS the min-start
    # tie-break.  One [.., 32, 128] score tensor replaces the former
    # 5-length argmax loop (~40 passes -> ~6).  Bit-equality holds because the
    # masked |spec| padding adds +0.0 to the cumsum, so the capped
    # full-length score is bitwise the plateau value the per-length
    # formulation computed.
    cum = jnp.cumsum(absb, axis=-1)                       # [..., 32, 128]
    pad = jnp.pad(cum, [(0, 0)] * (cum.ndim - 1) + [(1, 0)])
    starts = jnp.arange(128)
    spb = jnp.asarray(T.SPECS_PER_BLOCK)
    ext = jnp.concatenate(
        [cum, jnp.repeat(cum[..., -1:], MAX_TONAL_LEN - 1, axis=-1)],
        axis=-1)
    score = ext[..., MAX_TONAL_LEN - 1:] - pad[..., :-1]  # [..., 32, 128]
    score = jnp.where(starts < spb[:, None], score, -1.0)
    best_start = jnp.argmax(score, axis=-1).astype(jnp.int32)
    best_score = jnp.max(score, axis=-1)
    # window |values| at the chosen start (masked |spec| is 0 beyond the
    # block, so the last-nonzero rule also caps len at the block end)
    k128 = jnp.arange(128)
    sel_w = k128[None, :] - best_start[..., None]         # [..., 32, 128]
    offs = jnp.arange(MAX_TONAL_LEN)
    va = jnp.stack(
        [jnp.sum(jnp.where(sel_w == k, absb, 0.0), axis=-1)
         for k in range(MAX_TONAL_LEN)], axis=-1)         # [..., 32, 5]
    best_len = jnp.maximum(
        jnp.max(jnp.where(va > 0, offs + 1, 0), axis=-1), 1).astype(jnp.int32)

    active = gate & (best_score > 0.0)
    start_abs = jnp.asarray(T.SPECS_START) + best_start
    ln = jnp.where(active, best_len, 0)

    # lift the run values from the block view (one-hot over in-block
    # offsets; the runs never cross BFU boundaries) and zero them in place
    offs = jnp.arange(MAX_TONAL_LEN)
    in_run = active[..., None] & (offs < ln[..., None])   # [..., 32, 5]
    k128 = jnp.arange(128)
    sel = (k128[None, :] - best_start[..., None])         # [..., 32, 128]
    run_mask = active[..., None] & (sel >= 0) \
        & (sel < ln[..., None])                           # [..., 32, 128]
    # at most one nonzero per (bfu, k) slot, so each masked sum is exact;
    # looping the 5 offsets avoids the [..., 32, 5, 128] one-hot temp
    vals = jnp.stack(
        [jnp.sum(jnp.where((sel == k) & run_mask, blocks, 0.0), axis=-1)
         for k in range(MAX_TONAL_LEN)], axis=-1)
    vals = jnp.where(in_run, vals, 0.0)

    # zero the lifted runs out of the spectrum (atrac3denc.cpp:635-639)
    specs_out = specblocks.from_blocks(
        jnp.where(run_mask, 0.0, blocks))

    planes = {"active": active, "start": start_abs * active,
              "len": ln, "values": vals}
    return specs_out, regroup(planes)


BLOCK_LEN = 7       # MapTonalComponents groups <=7 consecutive coefficients


def regroup(run_planes):
    """Per-BFU runs -> coded tonal blocks (MapTonalComponents,
    atrac3denc.cpp:646-662): the concatenated components regroup into runs
    of CONSECUTIVE spectral positions, split every 7 — merging across BFU
    boundaries; each block's BFU identity is its first component's BFU.

    Returns block planes: active [..., 32] bool, start/len/bfu [..., 32],
    values [..., 32, 7].
    """
    act = run_planes["active"]
    start = run_planes["start"]
    ln = run_planes["len"]
    vals = run_planes["values"]

    # flatten the (ascending) per-BFU runs to component streams [..., 160]
    offs = jnp.arange(MAX_TONAL_LEN)
    cvalid = act[..., None] & (offs < ln[..., None])
    cpos = jnp.where(cvalid, start[..., None] + offs, 1 << 20)
    cbfu = jnp.broadcast_to(_IOTA32[:, None], cpos.shape)
    flat = lambda x: x.reshape(x.shape[:-2] + (-1,))
    cpos, cval, cvalid_f, cbfu = (flat(cpos), flat(vals), flat(cvalid),
                                  flat(cbfu))

    # previous VALID component's position (the streams carry padding slots
    # between runs; positions are ascending, so a running max skips them)
    cp = jnp.where(cvalid_f, cpos, -(1 << 20))
    prev_pos = jnp.concatenate(
        [jnp.full(cp.shape[:-1] + (1,), -(1 << 20), cp.dtype),
         jax.lax.cummax(cp, axis=cp.ndim - 1)[..., :-1]], axis=-1)
    new_run = cvalid_f & (cpos != prev_pos + 1)
    # packed component rank, ignoring padding slots
    rank = jnp.cumsum(cvalid_f, axis=-1) - 1
    run_start_rank = jax.lax.cummax(
        jnp.where(new_run, rank, -1), axis=cp.ndim - 1)
    off_in_run = rank - run_start_rank
    # block boundary: new run, or every BLOCK_LEN components within a run
    new_block = cvalid_f & (new_run | (off_in_run % BLOCK_LEN == 0))
    block_id = jnp.cumsum(new_block, axis=-1) - 1      # [..., 160]
    within = off_in_run % BLOCK_LEN

    # scatter components into [..., 32, 7]: each (block, within) slot holds
    # at most one component, so two chained one-hot contractions are exact
    # in f32 HIGHEST — and never materialize the [..., 160, 32, 7] product
    # the old single-oh formulation paid 4 full passes over
    nb = 32
    ohb = jnp.where(cvalid_f[..., None],
                    jax.nn.one_hot(block_id, nb, dtype=cval.dtype), 0.0)
    ohj = jax.nn.one_hot(within, BLOCK_LEN, dtype=cval.dtype)
    packed = jnp.stack([cval, cvalid_f.astype(cval.dtype),
                        cpos.astype(cval.dtype),
                        cbfu.astype(cval.dtype)], axis=-1)  # [..., 160, 4]
    hp = jax.lax.Precision.HIGHEST
    tmp = jnp.einsum("...cx,...cj->...cjx", packed, ohj,
                     precision=hp)                      # [..., 160, 7, 4]
    out = jnp.einsum("...cjx,...cb->...bjx", tmp, ohb,
                     precision=hp)                      # [..., 32, 7, 4]
    bvals = out[..., 0]
    bcount = out[..., 1]
    bpos = out[..., 2]
    bbfu = out[..., 3]

    blen = jnp.sum(bcount, axis=-1).astype(jnp.int32)
    bactive = blen > 0
    bstart = jnp.where(bactive, bpos[..., 0].astype(jnp.int32), 0)
    bfu_first = jnp.where(bactive, bbfu[..., 0].astype(jnp.int32), 0)
    return {"active": bactive, "start": bstart, "len": blen,
            "bfu": bfu_first, "values": bvals}


def scale_groups(planes):
    """Scale tonal blocks like MapTonalComponents: per-block block float.

    Returns planes extended with sfi [..., 32] and vlc_cost [..., 32, 8]
    (VLC spectrum bits at each quantizer 0..7; only 2..7 used)."""
    vals = planes["values"]
    in_run = jnp.arange(BLOCK_LEN) < planes["len"][..., None]
    sfi, scaled, _ = scale_ops.scale_blocks(
        vals, jnp.ones_like(vals, bool), jnp.asarray(T.SCALE_TABLE))
    # padding is zero so it does not affect maxabs; mask scaled anyway
    scaled = scaled * in_run

    # mantissas per quantizer: plain lrint, no EA (atrac3_bitstream.cpp:576)
    from .bitalloc import _vlc_bits_arith
    mant = jnp.round(scaled[..., None, :]
                     * jnp.asarray(T.MAX_QUANT)[:, None]).astype(jnp.int32)
    idx = jnp.where(mant < 0, -mant * 2, jnp.where(mant > 0, mant * 2 - 1, 0))
    # per static quantizer: step-function table arithmetic, no gathers
    vlc = jnp.stack(
        [jnp.sum(jnp.where(in_run,
                           _vlc_bits_arith(idx[..., qq, :],
                                           min(max(qq - 1, 0), 6)), 0),
                 axis=-1)
         for qq in range(8)], axis=-1)
    planes = dict(planes)
    planes["sfi"] = sfi
    planes["vlc_cost"] = vlc.astype(jnp.int32)
    planes["mant"] = mant
    return planes


def block_quant(planes, wl, num_bfu):
    """(active, quant) per tonal block for an allocation: quantizer =
    clamp(alloc[first-component BFU] + 4, 2, 7); blocks whose BFU fell off
    the shrunk allocation table are dropped (atrac3_bitstream.cpp:417-424)."""
    bfu = planes["bfu"]
    active = planes["active"] & (bfu < num_bfu[..., None])
    bfu_oh = jax.nn.one_hot(bfu, 32, dtype=jnp.float32)
    # default precision: small integers (wl <= 7) are exact even in TF32
    wl_b = jnp.einsum("...k,...bk->...b", wl.astype(jnp.float32), bfu_oh
                      ).astype(jnp.int32)
    quant = jnp.clip(jnp.where(active, wl_b + 4, 0), 2, 7)
    return active, jnp.where(active, quant, 0)


def make_cost_fn(planes):
    """Build tonal_bits_fn(alloc_wl) -> [...] section bits for the rate
    control (EncodeTonalComponents dry-run, atrac3_bitstream.cpp:453-595).

    Closed form instead of the bucket automaton: block positions ascend, so
    within one (quantizer, len) bucket stream the 64-line anchor group and
    the 256-line window index are non-decreasing, which collapses the
    sequential subgroup walk (see make_cost_fn_scan) to pairwise predicates:

      * a block opens a subgroup iff it is the first of its bucket, or its
        rank within the same (bucket, pos>>6) cluster is 8, 15, 22, ...
        (the limiter hits 7 on every 8th member of one 64-aligned group);
      * a block opens a window-count section iff it opens a subgroup or no
        earlier same-bucket block shares its pos>>8 (wins are
        non-decreasing, so "differs from the immediate predecessor" equals
        "no earlier member has the same window").

    One fused elementwise+reduce over a [32, 32] pair matrix replaces the
    32-step scan with six [..., 64] carries — the scan's HBM round trips
    made it the single hottest stage of the whole encoder (PERF.md).
    tests/test_at3_tonal_cost.py pins equality against the scan oracle.
    """
    ln = planes["len"]
    pos = planes["start"]
    vlc = planes["vlc_cost"]

    # static pair predicates (allocation-independent)
    grp = pos >> 6
    win = pos >> 8
    lt = _IOTA32[:, None] > _IOTA32[None, :]          # [i, j]: j < i
    le = _IOTA32[:, None] >= _IOTA32[None, :]         # [i, j]: j <= i
    same_len = ln[..., :, None] == ln[..., None, :]
    pre_lg = le & same_len & (grp[..., :, None] == grp[..., None, :])
    pre_lw = lt & same_len & (win[..., :, None] == win[..., None, :])
    pre_lb = lt & same_len

    def cost(wl, num_bfu):
        active, quant = block_quant(planes, wl, num_bfu)

        vlc_at_q = sum(jnp.where(quant == qq, vlc[..., qq], 0)
                       for qq in range(2, 8))        # quant clamps to 2..7
        member_bits = jnp.where(active, 12 + vlc_at_q, 0)
        base = jnp.sum(member_bits, axis=-1)

        # same-bucket pair mask at this allocation (bucket = quant*8+len;
        # quant equality x len equality), j restricted to active blocks
        qeq = quant[..., :, None] == quant[..., None, :]
        actj = active[..., None, :]
        sb_lt = actj & qeq & pre_lb                   # j < i, same bucket
        first = active & ~jnp.any(sb_lt, axis=-1)
        cnt = jnp.sum((actj & qeq & pre_lg).astype(jnp.int32), axis=-1)
        brk = active & (cnt > 1) & ((cnt - 1) % 7 == 0)
        new_sub = first | brk
        samewin = jnp.any(actj & qeq & pre_lw, axis=-1)
        new_win = active & (new_sub | ~samewin)

        tcsgn = jnp.sum(new_sub, axis=-1)
        sub_bits = 10 * tcsgn + 12 * jnp.sum(new_win, axis=-1)
        return 5 + jnp.where(tcsgn > 0, 2 + sub_bits + base, 0)

    return cost


def make_cost_fn_scan(planes):
    """The original sequential-automaton formulation of make_cost_fn
    (GroupTonalComponents walk, atrac3_bitstream.cpp:453-595, scanned over
    block slots with per-bucket state).  Kept as the test oracle for the
    closed form above."""
    ln = planes["len"]
    pos = planes["start"]
    vlc = planes["vlc_cost"]

    def cost(wl, num_bfu):
        active, quant = block_quant(planes, wl, num_bfu)
        bucket = jnp.where(active, quant * 8 + ln, 0)     # 0 = inactive

        vlc_at_q = sum(jnp.where(quant == qq, vlc[..., qq], 0)
                       for qq in range(2, 8))        # quant clamps to 2..7
        member_bits = jnp.where(active, 12 + vlc_at_q, 0)
        base = jnp.sum(member_bits, axis=-1)

        nbuckets = 64
        bids = jnp.arange(nbuckets)

        def step(state, g):
            anchor, limiter, prev_win, started, nsub, nwin = state
            m_active = active[..., g]
            m_bucket = bucket[..., g]
            m_pos = pos[..., g]
            here = m_active[..., None] & (bids == m_bucket[..., None])

            first = here & ~started
            inwin = (m_pos[..., None] - (anchor & ~63)) < 64
            lim2 = jnp.where(inwin, limiter + 1, 0)
            anchor2 = jnp.where(inwin, anchor, m_pos[..., None])
            brk = here & started & (lim2 >= 7)
            new_sub = first | brk

            anchor3 = jnp.where(new_sub, m_pos[..., None], anchor2)
            lim3 = jnp.where(new_sub, 0, lim2)
            # every active QMF band costs 4x3 bits of per-window counts
            # (atrac3_bitstream.cpp:546-555 writes c[j] for all 4 windows of
            # a flagged band, zero counts included); positions ascend, so
            # distinct bands == transitions of pos>>8 within the subgroup
            win = m_pos[..., None] >> 8
            new_win = here & (new_sub | (win != prev_win))

            anchor = jnp.where(here, anchor3, anchor)
            limiter = jnp.where(here, lim3, limiter)
            prev_win = jnp.where(here, win, prev_win)
            started = started | here
            nsub = nsub + new_sub
            nwin = nwin + new_win
            return (anchor, limiter, prev_win, started, nsub, nwin), None

        shape = active.shape[:-1] + (nbuckets,)
        init = (jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32),
                jnp.full(shape, -1, jnp.int32), jnp.zeros(shape, bool),
                jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32))
        (_, _, _, _, nsub, nwin), _ = jax.lax.scan(
            step, init, jnp.arange(32))

        tcsgn = jnp.sum(nsub, axis=-1)
        # per subgroup: 4 band flags + 3 coded-values + 3 quant;
        # per active band: 4 windows x 3-bit component counts
        sub_bits = jnp.sum(nsub * 10 + nwin * 12, axis=-1)
        return 5 + jnp.where(tcsgn > 0, 2 + sub_bits + base, 0)

    return cost
