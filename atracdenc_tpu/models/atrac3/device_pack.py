"""ATRAC3 sound-unit serialization ON DEVICE.

The host packer (frame.py + utils/bitpack.py) emits [K]-field planes and
packs bits on the CPU; for the batch pipeline that costs a full mantissa
plane device->host transfer plus single-core packing.  This module computes
the same field planes with jnp, derives every field's absolute bit offset in
closed form (prefix sums over the fixed entity grid — no sequential walk),
and deposits the final frame bytes with ops/bitdeposit.deposit_fields.

Byte-identical to frame.pack (tests/test_at3_device_pack.py); bit layout per
the reference writer (src/atrac/at3/atrac3_bitstream.cpp: WriteSoundUnit
:830-918, EncodeSpecs :597-636, tonal groups :409-595).

The tonal section is the only part whose field ORDER is data-dependent (the
subgroup/window interleave); since deposit_fields takes explicit offsets,
slot order never has to match stream order — each entity's offset is its
prefix sum over (subgroup, window) bit totals, and the 64-line-window
subgroup-split walk (GroupTonalComponents, atrac3_bitstream.cpp:427-449) is
one 32-step lax.scan.
"""
from functools import partial

import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from atracdenc_tpu.ops.bitdeposit import deposit_fields
from . import tables as T

_MAXLEN = T.MAX_SPECS_PER_BLOCK
_SLACK = 64                  # TBitStream may overrun; the tail is truncated
                             # (allocation keeps content <= the bit budget,
                             # so any spill is < one field; deposit drops
                             # out-of-range words safely besides)

_SPECS = _npc(np.asarray(T.SPECS_PER_BLOCK))
_CLC_LEN = _npc(np.asarray(T.CLC_LENGTH_TAB))
_VLC_CODE = _npc(np.asarray(T.VLC_CODE))
_VLC_BITS = _npc(np.asarray(T.VLC_BITS))
_CLC_RTAB = _npc(np.asarray(T.CLC_RTAB))
_VLC_PAIR_RTAB = _npc(np.asarray(T.VLC_PAIR_RTAB))


def _mask_sign(v, w):
    return (v.astype(jnp.int32) & ((1 << w.astype(jnp.int32)) - 1)) \
        .astype(jnp.uint32)


def _chain_merge(fields):
    """Merge stream-ADJACENT fields [(v, w), ...] into one field.

    Works for arbitrary data-dependent widths (holes included: w=0 fields
    vanish) as long as the total width stays <= 32.  Earlier fields land in
    the higher bits — exactly their earlier stream position under MSB-first
    deposit.  Each merged slot costs the one-hot bit-deposit a single K row
    instead of len(fields).

    Each field's value is masked to its width here (deposit_fields requires
    pre-masked values): a zero-width hole whose value plane holds garbage
    (e.g. wordlens past num_bfu) must contribute NOTHING."""
    def masked(v, w):
        return v.astype(jnp.uint32) & ((jnp.uint32(1) << w) - 1)

    v2, w = fields[0]
    w = w.astype(jnp.int32)
    v = masked(v2, w.astype(jnp.uint32))
    for v2, w2 in fields[1:]:
        w2 = w2.astype(jnp.int32)
        v = (v << w2.astype(jnp.uint32)) | masked(v2, w2.astype(jnp.uint32))
        w = w + w2
    return v, w


def _vlc_idx(m):
    return jnp.where(m < 0, -m * 2, jnp.where(m > 0, m * 2 - 1, 0))


def _vlc_steps(sel):
    """(bit-length, code) of spectrum codebook `sel` as step-function
    breakpoints over the symbol index instead of small-table gathers (see
    bitalloc._vlc_bits_arith).  Relies on the
    codebooks being canonical: codes are consecutive within an equal-length
    run, so code = idx + piecewise-constant offset (verified at import)."""
    lens = T.VLC_BITS[sel]
    codes = T.VLC_CODE[sel]
    n = int(np.max(np.nonzero(lens)[0])) + 1 if lens.any() else 0
    len_steps, code_steps = [(0, int(lens[0]))], [(0, int(codes[0]) - 0)]
    for j in range(1, n):
        if int(lens[j]) != int(lens[j - 1]):
            len_steps.append((j, int(lens[j]) - int(lens[j - 1])))
        off = int(codes[j]) - j
        prev_off = int(codes[j - 1]) - (j - 1)
        if off != prev_off:
            code_steps.append((j, off - prev_off))
        assert int(codes[j]) == int(codes[j - 1]) + 1 or \
            int(lens[j]) != int(lens[j - 1]), "non-canonical codebook"
    return len_steps, code_steps


_VLC_STEPS = [_vlc_steps(s) for s in range(7)]


def _vlc_arith(idx, sel):
    """(bits, code) for symbol index planes via step arithmetic."""
    len_steps, code_steps = _VLC_STEPS[sel]
    bits = jnp.full(idx.shape, len_steps[0][1], jnp.int32)
    for j, d in len_steps[1:]:
        bits = bits + d * (idx >= j)
    code = idx + code_steps[0][1]
    for j, d in code_steps[1:]:
        code = code + d * (idx >= j)
    return bits, code.astype(jnp.uint32)


def _tonal_fields(planes):
    """Tonal-section fields with explicit in-section bit offsets.

    Returns (values [N,S], widths [N,S], rel_offsets [N,S], total_bits [N]).
    """
    act = planes["tonal_active"].astype(bool)            # [N, 32]
    pos = planes["tonal_start"].astype(jnp.int32)
    ln = planes["tonal_len"].astype(jnp.int32)
    sfi = planes["tonal_sfi"].astype(jnp.int32)
    quant = planes["tonal_quant"].astype(jnp.int32)
    mant = planes["tonal_mant"].astype(jnp.int32)        # [N, 32, 7]
    n = act.shape[0]
    m32 = jnp.arange(32)

    bucket = quant * 8 + ln
    key = jnp.where(act, bucket * 64 + m32, 1 << 20)
    rank = jnp.sum((key[:, None, :] < key[:, :, None]), axis=-1)  # [N, 32]
    # one-hot permutation as f32-HIGHEST contractions: every value is a
    # small integer (<< 2^24) selected by a single 0/1 row, so the result
    # is exact (an int32 einsum would leave the matrix units idle)
    perm = (rank[:, None, :] == m32[None, :, None]) \
        .astype(jnp.float32)                              # [N, i, m]
    hi = jax.lax.Precision.HIGHEST

    def srt(x):
        return jnp.einsum("nim,nm->ni", perm, x.astype(jnp.float32),
                          precision=hi).astype(jnp.int32)

    s_act = srt(act.astype(jnp.int32)).astype(bool)
    s_bucket = srt(bucket)
    s_pos = srt(pos)
    s_sfi = srt(sfi)
    s_quant = srt(quant)
    s_ln = srt(ln)
    s_mant = jnp.einsum("nim,nmt->nit", perm, mant.astype(jnp.float32),
                        precision=hi).astype(jnp.int32)

    # subgroup-split walk (GroupTonalComponents :427-449) over sorted slots.
    # The member whose in-window run would reach 7 is EXCLUDED from the
    # current subgroup (the C slice ptr[start:cur] stops before it) and
    # starts the next one.
    def step(carry, xs):
        bprev, anchor, limiter, sgid = carry
        a, b, p = xs
        new_bucket = a & (b != bprev)
        within = (p - (anchor & ~63)) < 64
        lim_try = jnp.where(within, limiter + 1, 0)
        overflow = a & ~new_bucket & within & (lim_try >= 7)
        new_sg = new_bucket | overflow
        sgid = jnp.where(new_sg, sgid + 1, sgid)
        anchor = jnp.where(new_sg | (a & ~within), p, anchor)
        limiter = jnp.where(new_sg, 0, jnp.where(a, lim_try, limiter))
        out = jnp.where(a, sgid, -1)
        bprev = jnp.where(a, b, bprev)
        return (bprev, anchor, limiter, sgid), out

    z = jnp.zeros((n,), jnp.int32)
    init = (z - 1, z, z, z - 1)
    xs = (jnp.swapaxes(s_act, 0, 1), jnp.swapaxes(s_bucket, 0, 1),
          jnp.swapaxes(s_pos, 0, 1))
    _, sg_t = jax.lax.scan(step, init, xs, unroll=True)
    sg = jnp.swapaxes(sg_t, 0, 1)                        # [N, 32], -1 inactive
    num_sg = jnp.max(sg, axis=-1) + 1                    # [N]

    s32 = jnp.arange(32)
    in_sg = sg[:, None, :] == s32[None, :, None]         # [N, s, i]
    sg_quant = jnp.max(jnp.where(in_sg, s_quant[:, None, :], 0), -1)
    sg_len = jnp.max(jnp.where(in_sg, s_ln[:, None, :], 0), -1)
    sg_used = s32[None, :] < num_sg[:, None]

    win = s_pos >> 6                                     # [N, i]
    j16 = jnp.arange(16)
    in_win = win[:, None, :] == j16[None, :, None]       # [N, j, i]
    cnt = jnp.einsum("nsi,nji->nsj", in_sg.astype(jnp.float32),
                     in_win.astype(jnp.float32),
                     precision=hi).astype(jnp.int32)     # [N, s, j]
    band_any = (cnt.reshape(n, 32, 4, 4).sum(-1) > 0)    # [N, s, b]
    cw = jnp.where(band_any[:, :, j16 >> 2] & sg_used[:, :, None], 3, 0)

    # member VLC codes/bits (coding mode fixed to VLC, :484-487) — per-sel
    # step arithmetic selected by (qsel == sel) masks instead of a
    # _VLC_CODE[qsel, midx] per-element gather
    t7 = jnp.arange(7)
    midx = _vlc_idx(s_mant)                              # [N, i, 7]
    qsel = jnp.clip(s_quant - 1, 0, 6)[..., None]
    mcode = jnp.zeros(midx.shape, jnp.uint32)
    mbits_raw = jnp.zeros(midx.shape, jnp.int32)
    for sel in range(7):
        b_s, c_s = _vlc_arith(midx, sel)
        is_s = qsel == sel
        mcode = jnp.where(is_s, c_s, mcode)
        mbits_raw = jnp.where(is_s, b_s, mbits_raw)
    mbits = jnp.where(s_act[..., None] & (t7 < s_ln[..., None]),
                      mbits_raw, 0)
    member_bits = jnp.where(s_act, 12 + mbits.sum(-1), 0)  # [N, i]

    # member bits <= 103 and <= 32 members: all sums << 2^24, f32 exact
    mwin = jnp.einsum("nsi,nji,ni->nsj", in_sg.astype(jnp.float32),
                      in_win.astype(jnp.float32),
                      member_bits.astype(jnp.float32),
                      precision=hi).astype(jnp.int32)    # M(s,j) bits
    sg_bits = jnp.where(sg_used, 10 + (cw + mwin).sum(-1), 0)
    head_bits = 5 + jnp.where(num_sg > 0, 2, 0)
    sg_start = head_bits[:, None] + jnp.cumsum(sg_bits, -1) - sg_bits
    total = head_bits + sg_bits.sum(-1)

    wm = cw + mwin
    wstart = sg_start[:, :, None] + 10 + jnp.cumsum(wm, -1) - wm
    mem_region = wstart + cw                             # [N, s, j]

    # member offsets: segment prefix over sorted order (same sg & win)
    segkey = jnp.where(s_act, sg * 16 + win, -1)
    same_before = (segkey[:, None, :] == segkey[:, :, None]) \
        & (m32[None, :] < m32[:, None])[None]            # [N, i, j]
    mem_prefix = jnp.einsum("nij,nj->ni",
                            same_before.astype(jnp.float32),
                            member_bits.astype(jnp.float32),
                            precision=hi).astype(jnp.int32)
    flat_region = mem_region.reshape(n, 32 * 16)
    idx = jnp.clip(sg, 0, 31) * 16 + jnp.clip(win, 0, 15)
    moff = jnp.take_along_axis(flat_region, idx, axis=1) + mem_prefix
    moff = jnp.where(s_act, moff, 0)

    # --- assemble slots -----------------------------------------------------
    vals, wids, offs = [], [], []

    def emit(v, w, o):
        vals.append(v.astype(jnp.uint32).reshape(n, -1))
        wids.append(w.astype(jnp.int32).reshape(n, -1))
        offs.append(o.astype(jnp.int32).reshape(n, -1))

    emit(num_sg, jnp.full((n,), 5), jnp.zeros((n,)))     # count
    emit(z, jnp.where(num_sg > 0, 2, 0), jnp.full((n,), 5))  # mode = VLC

    # subgroup header: 4 band flags + (cv-1) + quant are stream-adjacent ->
    # one 10-bit slot per subgroup
    uw = jnp.where(sg_used, 1, 0)
    hdr = [(band_any[:, :, b].astype(jnp.uint32), uw) for b in range(4)]
    hdr += [((sg_len - 1).astype(jnp.uint32), 3 * uw),
            (sg_quant.astype(jnp.uint32), 3 * uw)]
    emit(*_chain_merge(hdr), sg_start)
    emit(cnt, cw, wstart)                                # window counts

    # member header: sfi (6) + in-window position (6) -> one 12-bit slot
    aw = jnp.where(s_act, 6, 0)
    emit(*_chain_merge([(s_sfi.astype(jnp.uint32), aw),
                        ((s_pos - (win << 6)).astype(jnp.uint32), aw)]),
         moff)
    # mantissa codes merged two lines per slot (<= 2x13 bits); codes of
    # inactive lines (mbits == 0) are garbage lookups — zero them so the
    # pair-OR below can't corrupt the active line (deposit needs pre-masked
    # values)
    mcode = jnp.where(mbits > 0, mcode, 0)
    mant_off = moff[:, :, None] + 12 + jnp.cumsum(mbits, -1) - mbits
    podd = [(0, 0)] * (mcode.ndim - 1) + [(0, 1)]
    codd = jnp.pad(mcode[..., 1::2], podd).astype(jnp.uint32)
    wodd = jnp.pad(mbits[..., 1::2], podd)
    mpair_v = (mcode[..., 0::2].astype(jnp.uint32)
               << wodd.astype(jnp.uint32)) | codd
    mpair_w = mbits[..., 0::2] + wodd
    emit(mpair_v, mpair_w, mant_off[..., 0::2])

    return (jnp.concatenate(vals, 1), jnp.concatenate(wids, 1),
            jnp.concatenate(offs, 1), total)


def channel_fields(planes, js1=False):
    """One channel's field planes [N, K] (values, widths, absolute offsets).

    planes: frame-major single-channel dict (same contract as
    frame.pack_channel).
    """
    num_bfu = planes["num_bfu"].astype(jnp.int32)
    mode = planes["coding_mode"].astype(jnp.int32)
    wl = planes["wordlen"].astype(jnp.int32)
    sfi = planes["sfi"].astype(jnp.int32)
    mant = planes["mant"].astype(jnp.int32)
    gnp = planes["gain_npoints"].astype(jnp.int32)
    glev = planes["gain_levels"].astype(jnp.int32)
    gloc = planes["gain_locs"].astype(jnp.int32)
    n = num_bfu.shape[0]
    num_qmf = planes.get("num_qmf")
    if num_qmf is None:
        num_qmf = jnp.full((n,), 4, jnp.int32)
    else:
        num_qmf = num_qmf.astype(jnp.int32)

    vals, wids = [], []

    def emit(v, w):
        vals.append(jnp.asarray(v).astype(jnp.uint32).reshape(n, -1))
        wids.append(jnp.asarray(w).astype(jnp.int32).reshape(n, -1))

    # channel id / JS params (atrac3_bitstream.cpp:848-853, 791-798)
    if js1:
        emit(jnp.full((n,), (0 << 13) | (7 << 10) | 0b11_11_11_11_11),
             jnp.full((n,), 14))
    else:
        emit(jnp.full((n,), 0x28), jnp.full((n,), 6))
    emit(num_qmf - 1, jnp.full((n,), 2))

    b4 = jnp.arange(4)
    in_band = b4[None, :] < num_qmf[:, None]             # [N, 4]
    emit_gain_v = []
    emit_gain_w = []
    # gain points merged two-per-slot: a point is 9 bits (level<<5 | loc);
    # active points are a prefix (p < npoints), so a pair slot holds its
    # first cnt=clamp(np-2p, 0, 2) points in the high bits (width 9*cnt)
    p4 = jnp.arange(4)
    pt = ((glev << 5) | gloc).astype(jnp.uint32)         # [N, 4, 8]
    pair_full = (pt[..., 0::2] << 9) | pt[..., 1::2]     # [N, 4, 4]
    cnt = jnp.clip(gnp[:, :, None] - 2 * p4, 0, 2)
    pair_v = pair_full >> (9 * (2 - cnt)).astype(jnp.uint32)
    pair_w = 9 * cnt
    for band in range(4):
        emit_gain_v.append(jnp.where(in_band[:, band], gnp[:, band], 0)
                           [:, None])
        emit_gain_w.append(jnp.where(in_band[:, band], 3, 0)[:, None])
        emit_gain_v.append(pair_v[:, band])
        emit_gain_w.append(pair_w[:, band])
    emit(jnp.concatenate(emit_gain_v, 1), jnp.concatenate(emit_gain_w, 1))

    pre_v = jnp.concatenate(vals, 1)
    pre_w = jnp.concatenate(wids, 1)
    pre_off = jnp.cumsum(pre_w, -1) - pre_w
    pre_end = pre_off[:, -1] + pre_w[:, -1]

    if "tonal_active" in planes:
        tv, tw, trel, tbits = _tonal_fields(planes)
    else:
        tv = jnp.zeros((n, 1), jnp.uint32)
        tw = jnp.full((n, 1), 5, jnp.int32)
        trel = jnp.zeros((n, 1), jnp.int32)
        tbits = jnp.full((n,), 5, jnp.int32)
    t_off = pre_end[:, None] + trel
    post_base = pre_end + tbits

    vals, wids = [], []
    emit(num_bfu - 1, jnp.full((n,), 5))
    emit(mode, jnp.full((n,), 1))

    in_use = jnp.arange(32)[None, :] < num_bfu[:, None]
    used = in_use & (wl > 0)
    wl_v = wl.astype(jnp.uint32)
    wl_w = jnp.where(in_use, 3, 0)
    for g in range(0, 32, 8):                     # 8 x 3b = 24 bits max
        emit(*_chain_merge([(wl_v[:, i], wl_w[:, i])
                            for i in range(g, g + 8)]))
    sfi_v = jnp.where(used, sfi, 0).astype(jnp.uint32)
    sfi_w = jnp.where(used, 6, 0)
    for g in range(0, 32, 4):                     # 4 x 6b = 24 bits max
        emit(*_chain_merge([(sfi_v[:, i], sfi_w[:, i])
                            for i in range(g, g + 4)]))

    # spectrum planes (mirrors frame.pack_channel:198-231); all table
    # lookups are static per-wordlen step arithmetic, selected by (wl == w)
    # masks, no small-table gathers
    line_valid = (jnp.arange(_MAXLEN)[None, :] < _SPECS[:, None])[None]
    clc_mode = used & (mode == 1)[:, None]
    vlc_mode = used & (mode == 0)[:, None]

    vidx = _vlc_idx(mant)
    clc_w = jnp.zeros(mant.shape, jnp.int32)
    clc_v = jnp.zeros(mant.shape, jnp.uint32)
    vbits = jnp.zeros(mant.shape, jnp.int32)
    vcode = jnp.zeros(mant.shape, jnp.uint32)
    for w in range(2, 8):
        is_w = (wl == w)[:, :, None]
        nb = int(T.CLC_LENGTH_TAB[w])
        clc_w = jnp.where(is_w, nb, clc_w)
        clc_v = jnp.where(is_w, _mask_sign(mant, jnp.int32(nb)), clc_v)
        b_w, c_w = _vlc_arith(vidx, min(w - 1, 6))
        vbits = jnp.where(is_w, b_w, vbits)
        vcode = jnp.where(is_w, c_w, vcode)

    single = (wl > 1)[:, :, None] & line_valid
    clc_w = jnp.where(single & clc_mode[:, :, None], clc_w, 0)
    vlc_w = jnp.where(single & vlc_mode[:, :, None], vbits, 0)

    pair_valid = (jnp.arange(64)[None, :] < (_SPECS // 2)[:, None])[None]
    a = mant[:, :, 0::2]
    b = mant[:, :, 1::2]
    # CLC_RTAB[m+2] for m in [-2,1] == (m+2) ^ 2 (atrac3.h:199-204)
    clcp_v = (((jnp.clip(a, -2, 1) + 2) ^ 2).astype(jnp.uint32) << 2) | \
        ((jnp.clip(b, -2, 1) + 2) ^ 2).astype(jnp.uint32)
    key = 3 * (jnp.clip(a, -1, 1) + 1) + (jnp.clip(b, -1, 1) + 1)
    vlcp_v = jnp.zeros(a.shape, jnp.uint32)
    vlcp_w = jnp.zeros(a.shape, jnp.int32)
    for k in range(9):
        pi = int(T.VLC_PAIR_RTAB[k])
        vlcp_v = jnp.where(key == k, int(T.VLC_CODE[0, pi]), vlcp_v)
        vlcp_w = jnp.where(key == k, int(T.VLC_BITS[0, pi]), vlcp_w)

    wl_gt1 = (wl > 1)[:, :, None]
    spec_v = jnp.where(wl_gt1, jnp.where(clc_mode[:, :, None], clc_v,
                                         vcode), 0)
    spec_w = jnp.where(wl_gt1, clc_w + vlc_w, 0)
    # unused bfus can carry wl > 1 with garbage codes at width 0 — zero the
    # value wherever the width is 0 (pair-merge ORs values together)
    spec_v = jnp.where(spec_w > 0, spec_v, 0)

    # merged plane: slot j of bfu b covers lines (2j, 2j+1).  Two adjacent
    # single-line codes concatenate into one <=28-bit field (first line in
    # the high bits = earlier stream position); a wl==1 pair code occupies
    # the same slot.  This halves the deposit slot count, and the static
    # per-bfu trim below drops the always-empty padding lines (the K axis
    # is what the one-hot bit-deposit pays for).
    mv = (spec_v[:, :, 0::2] << spec_w[:, :, 1::2]) | spec_v[:, :, 1::2]
    mw = spec_w[:, :, 0::2] + spec_w[:, :, 1::2]
    pair_clc = clc_mode[:, :, None] & (wl == 1)[:, :, None] & pair_valid
    pair_vlc = vlc_mode[:, :, None] & (wl == 1)[:, :, None] & pair_valid
    mv = jnp.where(pair_clc, clcp_v, jnp.where(pair_vlc, vlcp_v, mv))
    mw = jnp.where(pair_clc, 4, jnp.where(pair_vlc, vlcp_w, mw))

    halves = [int(x) // 2 for x in np.asarray(T.SPECS_PER_BLOCK)]
    mv_t = jnp.concatenate(
        [mv[:, b, :h] for b, h in enumerate(halves)], axis=1)
    mw_t = jnp.concatenate(
        [mw[:, b, :h] for b, h in enumerate(halves)], axis=1)
    emit(mv_t, mw_t)

    post_v = jnp.concatenate(vals, 1)
    post_w = jnp.concatenate(wids, 1)
    post_off = post_base[:, None] + jnp.cumsum(post_w, -1) - post_w

    values = jnp.concatenate([pre_v, tv, post_v], 1)
    widths = jnp.concatenate([pre_w, tw, post_w], 1)
    offsets = jnp.concatenate([pre_off, t_off, post_off], 1)
    return values, widths, offsets


def _empty_js_channel1(n):
    return {
        "num_bfu": jnp.ones((n,), jnp.int32),
        "coding_mode": jnp.ones((n,), jnp.int32),
        "wordlen": jnp.zeros((n, 32), jnp.int32),
        "sfi": jnp.zeros((n, 32), jnp.int32),
        "mant": jnp.zeros((n, 32, _MAXLEN), jnp.int32),
        "gain_npoints": jnp.zeros((n, 4), jnp.int32),
        "gain_levels": jnp.zeros((n, 4, 8), jnp.int32),
        "gain_locs": jnp.zeros((n, 4, 8), jnp.int32),
        "num_qmf": jnp.ones((n,), jnp.int32),
    }


@partial(jax.jit, static_argnames=("frame_bytes", "js"))
def pack_device_batch(planes, frame_bytes, js=False):
    """Batched pack: leaves shaped [S, C, F, ...] ([S, F] for ms_shift /
    loudness) -> [S, F, frame_bytes].  Packing is frame-local, so the
    stream axis folds into the frame axis — one fused program instead of a
    per-stream vmap (which is dispatch-bound for the small tonal/scan ops).
    """
    s, c, f = planes["num_bfu"].shape[:3]
    merged = {}
    for k, v in planes.items():
        if k in ("ms_shift", "loudness"):
            merged[k] = v.reshape((s * f,) + v.shape[2:])
        else:
            vv = jnp.swapaxes(v, 0, 1)          # [C, S, F, ...]
            merged[k] = vv.reshape((c, s * f) + v.shape[3:])
    out = pack_device(merged, frame_bytes, js)
    return out.reshape(s, f, frame_bytes)


@partial(jax.jit, static_argnames=("frame_bytes", "js"))
def pack_device(planes, frame_bytes, js=False):
    """Device counterpart of frame.pack: [C, F, ...] planes -> [F, B] bytes.
    Byte-identical to the host path (mono duplication, JS byte-reversal and
    M/S byte-budget boundary per atrac3_bitstream.cpp:899-914)."""
    c = planes["num_bfu"].shape[0]
    n = planes["num_bfu"].shape[1]
    half = frame_bytes // 2
    shift = planes.get("ms_shift")
    if shift is None:
        shift = jnp.zeros((n,), jnp.int32)
    shift = shift.astype(jnp.int32)

    chans = [{k: v[ch] for k, v in planes.items()
              if k not in ("loudness", "ms_shift")} for ch in range(c)]
    js1_flags = [False] * len(chans)
    if js and c == 1:
        chans.append(_empty_js_channel1(n))
        js1_flags.append(True)
    elif js:
        js1_flags[1] = True

    # a non-JS channel only ever owns `half` bytes of the frame; the JS
    # boundary moves per frame (M/S byte shift), so those buffers span the
    # whole frame.  The deposit's one-hot work is K x words — halving the
    # word span halves the stage.
    span = frame_bytes if js else half
    bufs = []
    for p, js1 in zip(chans, js1_flags):
        v, w, o = channel_fields(p, js1=js1)
        bufs.append(deposit_fields(v, w, o, span + _SLACK,
                                   frame_chunk=128)[:, :span])

    if not js:
        if c == 1:
            return jnp.concatenate([bufs[0]] * 2, axis=1)
        return jnp.concatenate([bufs[0], bufs[1]], axis=1)

    j = jnp.arange(frame_bytes)[None, :]
    boundary = (half + shift)[:, None]
    rows = jnp.arange(n)[:, None]
    return jnp.where(j < boundary, bufs[0][rows, j],
                     bufs[1][rows, frame_bytes - 1 - j]).astype(jnp.uint8)
