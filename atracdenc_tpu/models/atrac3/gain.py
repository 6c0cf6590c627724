"""ATRAC3 gain control, batched over all frames.

Behavioral port of the reference's streaming gain-curve builder
(src/atrac3denc.cpp:299-579 CreateSubbandInfo + src/transient_detector.cpp
AnalyzeGain/CalcCurve + src/transient_spectral_upsampler.cpp), restructured
for whole-track batches:

  * the 8x spectral upsampler is a batched rFFT/irFFT pair;
  * per-subframe staircase construction (sticky quantization, transition
    pruning, point budget) runs as fixed 32-step scans over [C, F, 4] lanes;
  * the three pieces of cross-frame context (LastLevel, LastHpfEnergy,
    LastTarget — transient_detector.h:61-65) are pure per-frame functions
    combined with shift / hold-last-valid gathers, so nothing is sequential.

The reference's last encoded frame sees stale lookahead data from the
engine's drain pass (pcmengin.h:171-183); here the final frame's lookahead is
silence instead, which only perturbs the last frame's curves.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from . import tables as T
from .mdct import gain_divisors

# upsampler (transient_spectral_upsampler.h:66-96)
_IN_N = 512
_UPS = 8
_OUT_N = 4096
_EPS = 0.15
_SAMPLE_RATE = 11025.0
_LOW_CUT_HZ = 800.0
_LOW_CUT_BIN = int(np.ceil(_LOW_CUT_HZ * _IN_N / _SAMPLE_RATE))   # 38
HIGH_FREQ_THRESHOLD = 0.05

# CreateSubbandInfo constants (atrac3denc.cpp:303,418,430)
_MIN_SCORE = 1.9
_MIN_SIGNAL = 1e-4
_MIN_HFR_FOR_AMPLIFY = 0.3

# CalcCurve constants (transient_detector.cpp)
_MIN_PLATEAU_LEN = 3
_MIN_PLATEAU_FRACTION = 0.4
_STICKY_MAX_INTRA = 7.0
_STICKY_MAX_INTER = 10.0
_TRANSIENT_WINDOW = 3
_MAX_CURVE_POINTS = 6

_GAIN_LEVEL = _npc(np.asarray(T.GAIN_LEVEL))


@lru_cache(maxsize=None)
def _planck_window() -> np.ndarray:
    e_n = _EPS * _IN_N
    w = np.ones(_IN_N, np.float32)
    n = np.arange(_IN_N, dtype=np.float64)
    left = (n > 0) & (n < e_n)
    zp = np.where(left, e_n * (1.0 / np.where(left, n, 1)
                               + 1.0 / np.where(left, n - e_n, 1)), 0.0)
    w[left] = (1.0 / (1.0 + np.exp(zp[left]))).astype(np.float32)
    m = _IN_N - n
    right = (m > 0) & (m < e_n)
    zp = np.where(right, e_n * (1.0 / np.where(right, m, 1)
                                + 1.0 / np.where(right, m - e_n, 1)), 0.0)
    w[right] = (1.0 / (1.0 + np.exp(zp[right]))).astype(np.float32)
    w[0] = 0.0
    return w


@lru_cache(maxsize=None)
def _hpf_response() -> np.ndarray:
    """H[k] for the 3-bin raised-cosine high-pass (upsampler step 3)."""
    h = np.ones(_IN_N // 2 + 1, np.float32)
    h[:_LOW_CUT_BIN] = 0.0
    h[_LOW_CUT_BIN] = 0.5
    h[_LOW_CUT_BIN + 1] = 1.0
    return h


def upsample(x):
    """[..., 512] -> (signal [..., 4096], high_freq_ratio [...])."""
    win = jnp.asarray(_planck_window())
    h = jnp.asarray(_hpf_response())
    spec = jnp.fft.rfft(x * win)                      # [..., 257]
    e = jnp.abs(spec) ** 2
    total = jnp.sum(e, axis=-1)
    filt = jnp.sum(e * h * h, axis=-1)
    hfr = jnp.where(total > 0, filt / total, 0.0)

    y = spec * (h * _UPS)
    # Nyquist bin: real part only, halved (upsampler step 3)
    y = y.at[..., _IN_N // 2].set(spec[..., _IN_N // 2].real * (_UPS * 0.5))
    pad = [(0, 0)] * (y.ndim - 1) + [(0, _OUT_N // 2 + 1 - y.shape[-1])]
    signal = jnp.fft.irfft(jnp.pad(y, pad), n=_OUT_N)
    return signal.astype(x.dtype), hfr.astype(x.dtype)


@lru_cache(maxsize=None)
def _region_matrices():
    """The whole upsampler is linear in x, and the gain analysis only reads
    samples [1024, 3072) of the 4096 output — so window+rFFT+HPF+8x
    zero-pad+irFFT collapse into ONE [512, 2048] matrix, and the hfr
    energies into a [512, 514] quadratic-form factor (rows = h-weighted
    Re/Im DFT of the windowed input).  Matmuls replace the small-FFT
    lowering; built once in float64.
    """
    win = _planck_window().astype(np.float64)
    h = _hpf_response().astype(np.float64)
    eye = np.diag(win)                                   # row m = win*e_m
    spec = np.fft.rfft(eye, axis=1)                      # [512 inputs, 257]
    y = spec * (h * _UPS)[None, :]
    y[:, _IN_N // 2] = spec[:, _IN_N // 2].real * (_UPS * 0.5)
    ypad = np.zeros((_IN_N, _OUT_N // 2 + 1), np.complex128)
    ypad[:, : y.shape[1]] = y
    sig = np.fft.irfft(ypad, n=_OUT_N, axis=1)           # [512, 4096]
    region = sig[:, 1024:3072]                           # [512, 2048]

    # energy factor: total = ||x @ E||^2, filt = ||x @ Ef||^2;
    # bin weights: one-sided rfft power as summed by the fft path (all bins
    # counted once — the reference upsampler sums |spec_k|^2 over k=0..256)
    dft = np.fft.rfft(np.diag(win), axis=1)              # [512, 257]
    E = np.concatenate([dft.real, dft.imag], axis=1)     # [512, 514]
    Ef = E * np.concatenate([h, h])[None, :]
    return (region.astype(np.float32), E.astype(np.float32),
            Ef.astype(np.float32))


def upsample_region(x):
    """[..., 512] -> (signal region [..., 2048] = upsample(x)[1024:3072],
    high_freq_ratio [...]) via matmuls (see _region_matrices).

    Numerically within ~1e-5 of the FFT path (not bit-identical — both are
    float approximations of the same linear operator; the reference uses
    kissfft and differs from either)."""
    m, e_mat, ef_mat = _region_matrices()
    m = jnp.asarray(m)
    e_mat = jnp.asarray(e_mat)
    ef_mat = jnp.asarray(ef_mat)
    hp = jax.lax.Precision.HIGHEST
    region = jnp.matmul(x, m, precision=hp)
    sp = jnp.matmul(x, e_mat, precision=hp)
    spf = jnp.matmul(x, ef_mat, precision=hp)
    total = jnp.sum(sp * sp, axis=-1)
    filt = jnp.sum(spf * spf, axis=-1)
    hfr = jnp.where(total > 0, filt / total, 0.0)
    return region, hfr.astype(x.dtype)


def _rms(x):
    return jnp.sqrt(jnp.mean(x * x, axis=-1))


# Batcher odd-even mergesort network for 8 elements (19 compare-exchanges)
_NET8 = ((0, 1), (2, 3), (4, 5), (6, 7),
         (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6),
         (0, 4), (1, 5), (2, 6), (3, 7),
         (2, 4), (3, 5),
         (1, 2), (3, 4), (5, 6))


def analyze_gain(region):
    """Upsampled analysis region [..., 2048] -> (gain [..., 32], lo, hi).

    AnalyzeGain with maxPoints=32 over [1024, 3072) plus the 8-micro-chunk
    inter-quartile estimates (transient_detector.cpp:95-136).

    The quartiles come from a 19-comparator Batcher network on the 8
    unstacked micro-chunk lanes instead of jnp.sort on a [.., 32, 8] minor
    axis (a sort over a tiny trailing dim); the network's min/max pairs
    on [.., 32] slices are plain elementwise code.  Order-statistic VALUES
    are identical to the sort's."""
    sub = region.reshape(region.shape[:-1] + (32, 64))
    gain = _rms(sub)
    micro = _rms(sub.reshape(sub.shape[:-1] + (8, 8)))
    xs = [micro[..., i] for i in range(8)]
    for i, j in _NET8:
        lo = jnp.minimum(xs[i], xs[j])
        hi = jnp.maximum(xs[i], xs[j])
        xs[i], xs[j] = lo, hi
    return gain, xs[2], xs[6]


def relation_to_idx(x):
    """Amplitude-ratio -> gain level index (transient_detector.cpp:141-149).

    GetFirstSetBit is the position of the highest set bit (0 for input 0)."""
    def fsb(v):
        v = v.astype(jnp.int32)
        return jnp.where(v > 0, 31 - jax.lax.clz(jnp.maximum(v, 1)), 0)

    lo = 4 + fsb(jnp.trunc(1.0 / jnp.maximum(x, 0.00048828125)))
    hi = 4 - fsb(jnp.trunc(jnp.minimum(x, 16.0)))
    return jnp.where(x <= 0.5, lo, hi).astype(jnp.int32)


def _median3(x):
    """3-point median with the reference's edge semantics
    (MedianFilter<1>, transient_detector.cpp:152-166: 2-element windows at
    the edges return the larger element, w[wn/2] with wn=2)."""
    left = jnp.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    right = jnp.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    mid = jnp.maximum(jnp.minimum(left, x),
                      jnp.minimum(jnp.maximum(left, x), right))
    lo_edge = jnp.maximum(x[..., :1], x[..., 1:2])
    hi_edge = jnp.maximum(x[..., -2:-1], x[..., -1:])
    return jnp.concatenate([lo_edge, mid[..., 1:-1], hi_edge], axis=-1)


def _find_plateau(g):
    """FindPlateau (transient_detector.cpp:178-238) over [..., 32] lanes.

    Returns (level, max_raw, release_at_end)."""
    n = 32
    max_raw = jnp.max(g, axis=-1)
    f = _median3(g)
    win = jnp.stack([f[..., j:j + n - 2] for j in range(3)], axis=-1)
    minv = jnp.min(win, axis=-1)                     # [..., 30]
    level = jnp.max(minv, axis=-1)
    # first window achieving the max (C updates on strictly-greater)
    j0 = jnp.argmax(minv, axis=-1)
    best_end = j0 + _MIN_PLATEAU_LEN - 1

    # extend right while filtered stays at plateau level
    idx = jnp.arange(n)
    above = f >= level[..., None]
    # smallest k > best_end with f[k] < level; best_end extends to k-1
    drop = (~above) & (idx > best_end[..., None])
    first_drop = jnp.min(jnp.where(drop, idx, n), axis=-1)
    best_end = first_drop - 1

    found = level >= 1e-6
    # release detection (transient_detector.cpp:215-234)
    tail = g[..., -1]
    hard = tail < level * 0.1
    after = idx > best_end[..., None]
    any_high_after = jnp.any(after & (g >= (level * 0.7)[..., None]), axis=-1)
    soft = ~any_high_after & (tail < level * 0.5)
    release = (best_end < n - 1) & (hard | soft)
    level = jnp.where(found, level, 0.0)
    release = jnp.where(found, release, False)
    return level, max_raw, release


def _boundary_scores(f):
    """BoundaryTransientScore for every loc in [1, 32)
    (transient_detector.cpp:276-297); returns [..., 33] with slot 0 unused."""
    n = 32
    eps = 1e-9
    pad = jnp.pad(f, [(0, 0)] * (f.ndim - 1) + [(_TRANSIENT_WINDOW, _TRANSIENT_WINDOW)],
                  constant_values=-np.inf)
    locs = jnp.arange(1, n)
    # left window [loc-3, loc), right [loc, loc+3)
    lwin = jnp.stack([pad[..., locs + k] for k in range(_TRANSIENT_WINDOW)],
                     axis=-1)        # pad index loc-3+3+k = loc+k
    rwin = jnp.stack([pad[..., locs + _TRANSIENT_WINDOW + k]
                      for k in range(_TRANSIENT_WINDOW)], axis=-1)
    lmax = jnp.maximum(jnp.max(lwin, axis=-1), 0.0)
    rmax = jnp.maximum(jnp.max(rwin, axis=-1), 0.0)
    # out-of-range entries are -inf; reference clamps window to [0, n)
    attack = (rmax + eps) / (lmax + eps)
    release = (lmax + eps) / (rmax + eps)
    score = jnp.maximum(attack, release)
    return jnp.concatenate(
        [jnp.ones(f.shape[:-1] + (1,), f.dtype), score], axis=-1)


def calc_curve(gain, lo, hi, saved_last_level, saved_last_target, min_score):
    """CalcCurve (transient_detector.cpp:299-482) over [...] lanes.

    Returns (levels [..., 32], keep [..., 32], target, last_level,
    last_target) where keep[sf] marks a curve point at loc = sf+1 with level
    levels[sf]; point lists are ascending in loc by construction.
    """
    plateau, max_raw, release = _find_plateau(gain)
    use_plateau = (plateau > 1e-6) & ~release \
        & (plateau >= max_raw * _MIN_PLATEAU_FRACTION)
    target = jnp.where(use_plateau, plateau, gain[..., -1])

    new_last_level = gain[..., -1]
    new_last_target = target

    emit = (target >= 1e-6) & (saved_last_level >= 1e-6)

    f = _median3(gain)
    max_gain = jnp.max(gain, axis=-1)

    intra = max_gain / jnp.maximum(target, 1e-9)
    hi_t = jnp.maximum(saved_last_target, target)
    lo_t = jnp.minimum(saved_last_target, target)
    inter = jnp.where(saved_last_target > 1e-6,
                      hi_t / jnp.maximum(lo_t, 1e-9), 1.0)
    sticky = (intra <= _STICKY_MAX_INTRA) & (inter <= _STICKY_MAX_INTER)

    # per-subframe levels with sticky +-1 suppression (sequential in sf)
    t_safe = jnp.maximum(target, 1e-20)[..., None]
    center = relation_to_idx(f / t_safe)
    r_lo = lo / t_safe
    r_hi = hi / t_safe
    i_lo = relation_to_idx(jnp.minimum(r_lo, r_hi))
    i_hi = relation_to_idx(jnp.maximum(r_lo, r_hi))
    min_idx = jnp.minimum(i_lo, i_hi)
    max_idx = jnp.maximum(i_lo, i_hi)

    def sticky_step(prev, xs):
        lvl, mn, mx = xs
        hold = sticky & ((mx - mn) <= 1) & (jnp.abs(lvl - prev) == 1) \
            & (prev >= mn) & (prev <= mx)
        out = jnp.where(hold, prev, lvl)
        return out, out

    first = center[..., 0]
    _, rest = jax.lax.scan(
        sticky_step, first,
        (jnp.moveaxis(center[..., 1:], -1, 0),
         jnp.moveaxis(min_idx[..., 1:], -1, 0),
         jnp.moveaxis(max_idx[..., 1:], -1, 0)))
    sf_level = jnp.concatenate(
        [first[..., None], jnp.moveaxis(rest, 0, -1)], axis=-1)

    # targetSf: one past the last non-neutral subframe among sf in [0, 31)
    sf_idx = jnp.arange(32)
    nonneutral = (sf_level != 4) & (sf_idx < 31)
    target_sf = jnp.max(jnp.where(nonneutral, sf_idx + 1, 0), axis=-1)

    score = _boundary_scores(f)                       # [..., 33]

    # leftward transition scan from targetSf-1 (transient_detector.cpp:401-437)
    def trans_step(prev, sf):
        lvl = sf_level[..., sf]
        loc = sf + 1
        in_range = loc <= target_sf
        change = in_range & (lvl != prev)
        delta = jnp.abs(lvl - prev)
        keep = change & ((loc == target_sf) | (delta >= 2)
                         | (score[..., loc] >= min_score))
        prev = jnp.where(keep, lvl, prev)
        return prev, (keep, delta)

    prev0 = jnp.full(target.shape, 4, jnp.int32)
    _, (keeps, deltas) = jax.lax.scan(
        trans_step, prev0, jnp.arange(30, -1, -1))
    keep = jnp.moveaxis(keeps, 0, -1)[..., ::-1]      # [..., 31] for sf 0..30
    delta = jnp.moveaxis(deltas, 0, -1)[..., ::-1]
    keep = jnp.pad(keep, [(0, 0)] * (keep.ndim - 1) + [(0, 1)])
    delta = jnp.pad(delta, [(0, 0)] * (delta.ndim - 1) + [(0, 1)])

    # trim to 6 points: priority = (delta desc, loc desc)
    # rank = number of kept transitions that outrank this one
    d_i = delta[..., :, None]
    d_j = delta[..., None, :]
    l_i = sf_idx[:, None]
    l_j = sf_idx[None, :]
    outranks = keep[..., None, :] & ((d_j > d_i) | ((d_j == d_i) & (l_j > l_i)))
    rank = jnp.sum(outranks, axis=-1)
    keep = keep & (rank < _MAX_CURVE_POINTS)

    keep = keep & emit[..., None]
    return sf_level, keep, target, new_last_level, new_last_target


def _subframe_divisors(levels, locs, npoints):
    """BuildSubframeDivisors (atrac3denc.cpp:228-255): mean sample divisor
    per 8-sample subframe."""
    div = gain_divisors(levels, locs, npoints)        # [..., 256]
    return jnp.mean(div.reshape(div.shape[:-1] + (32, 8)), axis=-1)


def _early_mismatch_score(gain, target, levels, locs, npoints):
    """CalcCurveEarlyMismatchScore (atrac3denc.cpp:259-297)."""
    eps = 1e-9
    div = _subframe_divisors(levels, locs, npoints)
    max_loc = jnp.max(jnp.where(jnp.arange(levels.shape[-1])
                                < npoints[..., None], locs, 0), axis=-1)
    eval_sf = jnp.minimum(32, jnp.maximum(3, max_loc + 3))
    sf = jnp.arange(32)
    active = sf < eval_sf[..., None]

    mod = gain / jnp.maximum(div, eps)
    e = jnp.log2(jnp.maximum(mod, eps) / jnp.maximum(target, eps)[..., None])
    fit = jnp.sum(jnp.where(active, e * e, 0.0), axis=-1) / eval_sf

    a = jnp.log2(jnp.maximum(div, eps))
    d = a[..., 1:] - a[..., :-1]
    w = 0.5 * (gain[..., :-1] + gain[..., 1:])
    pair_active = (sf[:-1] + 1) < eval_sf[..., None]
    leak = jnp.sum(jnp.where(pair_active, d * d * w, 0.0), axis=-1)
    wsum = jnp.sum(jnp.where(pair_active, w, 0.0), axis=-1)
    leak = jnp.where(wsum > eps, leak / wsum, leak)

    return jnp.where(target > 1e-9, fit + 0.25 * leak, 0.0)


def _keep_to_points(sf_level, keep):
    """Transition planes -> (levels [..., 8], locs [..., 8], npoints [...]).

    keep[sf] marks a point at loc = sf+1 with level sf_level[sf]; ascending
    loc order is position order."""
    n = jnp.sum(keep, axis=-1)
    # compaction by rank: the r-th kept sf lands in slot r (ascending loc
    # order preserved) — one-hot contraction instead of argsort + gathers
    rank = jnp.cumsum(keep.astype(jnp.int32), axis=-1) - 1
    slot = jnp.arange(8)
    oh = (keep[..., None] & (rank[..., None] == slot)).astype(jnp.int32)
    lev_sorted = jnp.sum(sf_level[..., None] * oh, axis=-2)
    loc_sorted = jnp.sum((jnp.arange(32) + 1)[:, None] * oh, axis=-2)
    valid = slot < n[..., None]
    return (jnp.where(valid, lev_sorted, 0).astype(jnp.int32),
            jnp.where(valid, loc_sorted, 0).astype(jnp.int32),
            n.astype(jnp.int32))


def init_ctx(c):
    """Fresh cross-frame gain context (CurveCtx zeros + the prev band tail)."""
    z = jnp.zeros((c, 4), jnp.float32)
    return {"last_level": z, "last_target": z, "last_hpf": z,
            "prev_tail": jnp.zeros((c, 4, 128), jnp.float32)}


def assemble_up_in(bands, ctx, next_head=None):
    """Upsampler input windows: [C, F, 4, 256] band frames -> [C, F, 4, 512]
    (prev 128 | frame 256 | next 128), with the chunk-carry tail from `ctx`
    and the lookahead `next_head` ([C, 4, 128], zeros at track end —
    the reference drain, atrac3denc.cpp:715-718)."""
    c, f, nb, _ = bands.shape
    if next_head is None:
        next_head = jnp.zeros((c, nb, 128), bands.dtype)
    stream = jnp.swapaxes(bands, 1, 2).reshape(c, nb, f * 256)
    prev128 = jnp.concatenate(
        [ctx["prev_tail"], stream[..., :-128]], axis=-1)
    next128 = jnp.concatenate(
        [stream[..., 256:], next_head, jnp.zeros_like(stream[..., :128])],
        axis=-1)
    up_in = jnp.concatenate([
        prev128.reshape(c, nb, f, 256)[..., :128],
        stream.reshape(c, nb, f, 256),
        next128.reshape(c, nb, f, 256)[..., :128],
    ], axis=-1)                                       # [C, 4, F, 512]
    return jnp.swapaxes(up_in, 1, 2)                  # [C, F, 4, 512]


def gain_control(bands, ctx=None, next_head=None, debug=False):
    """Full gain-curve construction for a whole track (or one exact chunk).

    bands: [C, F, 4, 256] per-frame band samples (the MDCT input domain).
    ctx: carried context from the previous chunk (init_ctx for track start);
    next_head: [C, 4, 128] first half of the frame after this chunk (the
    gain-analysis lookahead), zeros at track end like the reference's drain.
    Returns (levels [C, F, 4, 8], locs [C, F, 4, 8], npoints [C, F, 4],
    ctx_out); with debug=True also a dict of per-band intermediates for the
    YAML log (the reference's --yaml-log stream, yaml_log.h:19-57).
    """
    c, f, nb, _ = bands.shape
    if ctx is None:
        ctx = init_ctx(c)
    up_in = assemble_up_in(bands, ctx, next_head)     # [C, F, 4, 512]

    region, hfr = upsample_region(up_in)
    gain, lo, hi = analyze_gain(region)

    valid = hfr >= HIGH_FREQ_THRESHOLD                # CalcCurve ran here

    # cross-frame context (shift / hold-last-valid over the frame axis)
    cur_hpf = jnp.mean(gain, axis=-1)
    fidx = jnp.arange(f)[None, :, None]
    last_valid = jax.lax.cummax(jnp.where(valid, fidx, -1), axis=1)
    prev_valid = jnp.pad(last_valid, ((0, 0), (1, 0), (0, 0)),
                         constant_values=-1)[:, :-1]

    def hold(x, default):
        g = jnp.take_along_axis(x, jnp.maximum(prev_valid, 0), axis=1)
        return jnp.where(prev_valid >= 0, g, default)

    prev_hpf = hold(cur_hpf, ctx["last_hpf"][:, None])
    hpf_overlap = jnp.where((cur_hpf > 1e-9) & (prev_hpf > 1e-9),
                            prev_hpf / cur_hpf, 1.0)
    dyn_min_score = _MIN_SCORE * jnp.clip(hpf_overlap, 1.0, 1.5)

    # LastLevel is set on every frame: 0 when hfr-skipped, else gain[31]
    last_level_f = jnp.where(valid, gain[..., -1], 0.0)
    saved_last_level = jnp.concatenate(
        [ctx["last_level"][:, None], last_level_f[:, :-1]], axis=1)

    # the target depends only on the plateau analysis, so the LastTarget
    # hold chain resolves without running the full curve construction twice
    plateau, max_raw_p, release = _find_plateau(gain)
    use_plateau = (plateau > 1e-6) & ~release \
        & (plateau >= max_raw_p * _MIN_PLATEAU_FRACTION)
    tgt = jnp.where(use_plateau, plateau, gain[..., -1])
    saved_last_target = hold(jnp.where(valid, tgt, 0.0),
                             ctx["last_target"][:, None])
    sf_level, keep, tgt, _, _ = calc_curve(
        gain, lo, hi, saved_last_level, saved_last_target, dyn_min_score)
    keep = keep & valid[..., None]
    # an empty CalcCurve result skips the whole band, point0 included
    # (atrac3denc.cpp:395-399 `continue`), unlike the later clearing gates
    had_curve = jnp.any(keep, axis=-1)

    # --- CreateSubbandInfo post-processing (atrac3denc.cpp:410-562) ---
    max_gain = jnp.max(gain, axis=-1)
    clear = (max_gain < _MIN_SIGNAL) | (hfr < _MIN_HFR_FOR_AMPLIFY)
    band_idx = jnp.arange(4)[None, None, :]
    clear = clear | (band_idx >= 3)
    keep = keep & ~clear[..., None]

    levels, locs, npts = _keep_to_points(sf_level, keep)

    # explicit point0 (bands < 3 only)
    prev_target = saved_last_target
    loc0 = locs[..., 0]
    lev0 = levels[..., 0]
    has_pts = npts > 0
    n_before = jnp.where(has_pts, loc0, 0)
    sf = jnp.arange(32)
    pre_sum = jnp.sum(jnp.where(sf < n_before[..., None], gain, 0.0), axis=-1)
    pre_mean = pre_sum / jnp.maximum(n_before, 1)
    rms_next_mod = jnp.where(
        has_pts & (loc0 > 0), pre_mean / jnp.asarray(_GAIN_LEVEL)[lev0],
        jnp.where(~has_pts, jnp.mean(gain, axis=-1), 0.0))
    rms_valid = (~has_pts) | (loc0 > 0)

    can_p0 = valid & had_curve & (band_idx < 3) & rms_valid \
        & (prev_target > 1e-6) & (rms_next_mod > 1e-6)
    p0_level = relation_to_idx(
        prev_target / jnp.maximum(rms_next_mod, 1e-20))
    insert = can_p0 & ((p0_level != 4) | has_pts)

    # candidate curve with point0 prepended
    lev_p0 = jnp.concatenate([p0_level[..., None], levels[..., :-1]], axis=-1)
    loc_p0 = jnp.concatenate([jnp.zeros_like(loc0)[..., None],
                              locs[..., :-1]], axis=-1)
    np_p0 = jnp.minimum(npts + 1, 8)

    # guard (atrac3denc.cpp:509-553)
    score_before = _early_mismatch_score(gain, tgt, levels, locs, npts)
    score_after = _early_mismatch_score(gain, tgt, lev_p0, loc_p0, np_p0)
    desired = jnp.clip(prev_target / jnp.maximum(rms_next_mod, 1e-20),
                       T.GAIN_LEVEL[15], T.GAIN_LEVEL[0])
    first_lev_before = jnp.where(has_pts, lev0, 4)
    err_before = jnp.abs(jnp.log2(
        jnp.maximum(jnp.asarray(_GAIN_LEVEL)[first_lev_before], 1e-9)
        / jnp.maximum(desired, 1e-9)))
    err_after = jnp.abs(jnp.log2(
        jnp.maximum(jnp.asarray(_GAIN_LEVEL)[p0_level], 1e-9)
        / jnp.maximum(desired, 1e-9)))
    keep_by_boundary = (err_after + 0.20) < err_before
    revert = ~keep_by_boundary & (score_after > score_before * 1.02)
    use_p0 = insert & ~revert

    levels = jnp.where(use_p0[..., None], lev_p0, levels)
    locs = jnp.where(use_p0[..., None], loc_p0, locs)
    npts = jnp.where(use_p0, np_p0, npts)

    # drop a redundant point0 (same level as the next point,
    # atrac3denc.cpp:556-562)
    redundant = (npts >= 2) & (locs[..., 0] == 0) \
        & (levels[..., 0] == levels[..., 1])
    lev_drop = jnp.concatenate([levels[..., 1:],
                                jnp.zeros_like(levels[..., :1])], axis=-1)
    loc_drop = jnp.concatenate([locs[..., 1:],
                                jnp.zeros_like(locs[..., :1])], axis=-1)
    levels = jnp.where(redundant[..., None], lev_drop, levels)
    locs = jnp.where(redundant[..., None], loc_drop, locs)
    npts = jnp.where(redundant, npts - 1, npts)

    slot_valid = jnp.arange(8) < npts[..., None]

    # carried context after the last frame of this chunk
    lv = last_valid[:, -1]                            # [C, 4]
    def at_last(x, default):
        g = jnp.take_along_axis(x, jnp.maximum(lv, 0)[:, None], axis=1)[:, 0]
        return jnp.where(lv >= 0, g, default)
    ctx_out = {
        "last_level": last_level_f[:, -1],
        "last_target": at_last(jnp.where(valid, tgt, 0.0),
                               ctx["last_target"]),
        "last_hpf": at_last(cur_hpf, ctx["last_hpf"]),
        "prev_tail": bands[:, -1, :, 128:],
    }

    out = (jnp.where(slot_valid, levels, 0),
           jnp.where(slot_valid, locs, 0), npts, ctx_out)
    if debug:
        dbg = {"high_freq_ratio": hfr, "hpf_overlap_ratio": hpf_overlap,
               "dynamic_min_score": dyn_min_score, "gain": gain,
               "target": tgt, "prev_target": saved_last_target,
               "max_gain": max_gain}
        return out + (dbg,)
    return out


def safe_energy_scale(orig, mod):
    """SafeEnergyScale (atrac3denc.cpp:143-152)."""
    bad = (orig <= 1e-20) | (mod <= 1e-20) \
        | ~jnp.isfinite(orig) | ~jnp.isfinite(mod)
    s = orig / mod
    return jnp.where(bad | ~jnp.isfinite(s) | (s <= 0), 1.0, s)


def energy_scale(bands, div, scale, prev_half=None, prev_overlap_init=None):
    """CalcGainEnergyScale.Frame per band frame (atrac3denc.cpp:175-224).

    bands [C, F, 4, 256] raw band samples, div the per-frame divisor curves,
    scale the per-frame first gain level; prev_half / prev_overlap_init
    carry the stored MDCT half and NextOverlapScale across chunks.
    Returns (gs_frame [C, F, 4], carry (stored_last [C, 4, 256],
    next_overlap_last [C, 4])).
    """
    enc_win = jnp.asarray(T.ENCODE_WINDOW)
    stored = enc_win * (bands / div)                  # windowed modulated
    if prev_half is None:
        prev_stored = jnp.pad(stored[..., :-1, :, :],
                              [(0, 0), (1, 0), (0, 0), (0, 0)])
    else:
        prev_stored = jnp.concatenate(
            [prev_half[:, None], stored[..., :-1, :, :]], axis=1)
    prev_stored_e = jnp.sum(prev_stored * prev_stored, axis=-1)

    mod = bands / div
    w_cur = enc_win[::-1]
    w_next = enc_win
    cur_orig = jnp.sum((bands * w_cur) ** 2, axis=-1)
    cur_mod = jnp.sum((mod * w_cur) ** 2, axis=-1)
    next_orig = jnp.sum((bands * w_next) ** 2, axis=-1)
    next_mod = jnp.sum((mod * w_next) ** 2, axis=-1)

    next_overlap = safe_energy_scale(next_orig, next_mod)
    init = (jnp.ones_like(next_overlap[..., :1, :]) if prev_overlap_init
            is None else prev_overlap_init[:, None])
    prev_overlap_scale = jnp.concatenate(
        [init, next_overlap[..., :-1, :]], axis=1)
    prev_overlap_scale = jnp.where(
        jnp.isfinite(prev_overlap_scale) & (prev_overlap_scale > 0),
        prev_overlap_scale, 1.0)

    prev_orig = prev_stored_e * prev_overlap_scale
    prev_mod = prev_stored_e / (scale * scale)
    gs = safe_energy_scale(prev_orig + cur_orig, prev_mod + cur_mod)
    return gs, (stored[:, -1], next_overlap[:, -1])
