"""ATRAC3+ GHA tonal model: sinusoid extraction, envelopes, stereo sharing.

The reference delegates sinusoid estimation to the libgha submodule (absent
from its own tree) and wraps it in a round-based accept/refine protocol
(src/atrac/at3p/at3p_gha.cpp).  This is a from-scratch implementation with
the same wire model (TAt3PGhaData: quantized {FreqIndex, AmpSf, PhaseIndex}
per wave, <=8 tone subbands, per-subband envelopes, stereo tone sharing with
leader/follower) built for batch execution:

  * extraction: per (channel, frame, subband) greedy rounds on a zero-padded
    2048-point rFFT — the padded bin grid IS the 10-bit FreqIndex grid, so
    peak picking lands directly on quantized frequencies; amplitude/phase
    come from the peak bin, quantized to the 6-bit ladder 2^((sf-3)/4)
    (floor, AmplitudeToSf at3p_gha.cpp:1667-1676) and the 5-bit phase grid;
    psychoacoustic gates mirror PsyPreCheck (subband ATH + 23 dB-below-max
    cutoff, at3p_gha.cpp:955-973) and the 20-bin minimum tone distance
    (DoRound, at3p_gha.cpp:920-940);
  * envelopes: 4-sample-granularity longest-run detection on the fit
    residual (CheckResuidalAndApply, at3p_gha.cpp:492-579), with a second
    fit pass on the truncated window when the run ends early, and a
    next-frame continuation check (CheckNextFrame, at3p_gha.cpp:780-812)
    deciding whether a full-length tone carries a stop point;
  * stereo: per subband the follower channel shares the leader's tones when
    all its frequencies exist in the leader's set (FillFolowerRes,
    at3p_gha.cpp:1613-1664); SecondIsLeader when channel 1 uses more tone
    bands (FillResultBuf, at3p_gha.cpp:1522-1544);
  * synthesis matches the real ffmpeg decoder bit-for-bit in structure
    (ff_atrac3p_generate_tones + waves_synth, atrac3plusdsp.c:77-204,
    amplitude mode 1): the alignment — validated against the real decoder,
    tests/test_ffmpeg_oracle.py — makes content frame c receive the falling
    half of its own waves and the rising half of frame c+1's, with envelope
    fade-in/out at 4-sample steps and the cross-frame envelope
    reconstruction of generate_tones;
  * the residual handed to the MDCT subtracts exactly what a decoder will
    add back.

Wire-plane layout produced by extract():
  freq/amp_sf/phase/valid : [C, F, 8, MAX_WAVES]
  env_start, env_stop     : [C, F, 8] int32, -1 = point absent
  sharing                 : [F, 8] bool  (C == 2 only; else all False)
  leader                  : [F] int32    (0 or 1)
Planes are "wire-effective": shared subbands carry the leader's waves in
both channels' slots, so subtract()/synthesize() see what a decoder sees.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from atracdenc_tpu.ops.psy import calc_ath

NUM_TONE_SUBBANDS = 8       # the reference analyzes subbands 0..7
MAX_WAVES = 8               # greedy rounds per subband (wire allows 15)
MIN_FREQ_DIST = 20          # DoRound's minFreqDistanse
MAX_TOTAL_TONES = 48        # ApplyFilter aborts above this (at3p_gha.cpp:629)
_ACCEPT_RATIO = 0.9         # keep a tone only if it removes >=10% of energy


def _subband_ath() -> np.ndarray:
    """[8] power thresholds at the 0dB=32768 level (FillSubbandAth,
    at3p_gha.cpp:453-465)."""
    ath = calc_ath(16 * 1024, 44100)
    m = ath.reshape(16, 1024).min(axis=1)[:NUM_TONE_SUBBANDS]
    return np.power(10.0, 0.1 * (m + 90.0)).astype(np.float32)


_SUBBAND_ATH = _subband_ath()


def _quantize_wave(amp, phi_steps, freq):
    """Quantize (amplitude, phase-in-steps-at-frame-start, freq bin).

    Alignment (validated against the real ffmpeg decoder, see
    tests/test_ffmpeg_oracle.py): the decoder's band-frame timeline runs two
    frames behind the wire (one residual LOOK_AHEAD delay + one MDCT
    overlap-add delay), so a wave block's region-1 synthesis
    (pos = DEQ + i*freq, atrac3plusdsp.c:94 with reg_offset=128) lands on
    the SAME content frame the wave was fit on — DEQ(ph) is therefore the
    phase at the frame's own sample 0, exactly what the fit estimates.
    """
    sf = jnp.clip(jnp.floor(4.0 * jnp.log2(jnp.maximum(amp, 1e-20)) + 3.0),
                  0, 63).astype(jnp.int32)
    amp_q = 2.0 ** ((sf.astype(jnp.float32) - 3.0) / 4.0)
    ph = jnp.round(phi_steps / 64.0).astype(jnp.int32) & 31
    return sf, amp_q, ph


@lru_cache(maxsize=None)
def _wave_tables(length):
    """cos/sin of 2*pi*f*i/2048 on the 10-bit FreqIndex grid: [1024, length].

    Host numpy — baked into HLO (dispatch hygiene, atracdenc_tpu/__init__)."""
    f = np.arange(1024, dtype=np.int64)[:, None]
    i = np.arange(length, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((f * i) % 2048) / 2048.0
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _wave_sum(freq, ph, amp, i_offset, length=128):
    """Sum of waves over samples [0, length): pos = (ph<<6) + (i+i_offset)*f.
    freq/ph/amp: [..., W]; returns [..., length].

    sin(alpha_w + 2*pi*f_w*i/2048) expands to two fixed [1024, length]
    tables contracted with per-wave coefficients: 2 transcendentals per
    WAVE (vs per sample) and the per-sample work becomes a matmul instead
    of an elementwise chain."""
    cos_t, sin_t = _wave_tables(length)               # np [1024, length]
    base = jnp.mod((ph << 6) + i_offset * freq, 2048)
    alpha = (2.0 * np.pi / 2048.0) * base.astype(jnp.float32)
    a = amp * jnp.sin(alpha)                          # pairs with cos_t
    b = amp * jnp.cos(alpha)                          # pairs with sin_t
    # scatter per-wave coefficients onto the 1024-bin grid (freqs within a
    # lane are distinct — the 20-bin guard — so the sum never collides)
    oh = (freq[..., None] == jnp.arange(1024)).astype(jnp.float32)
    coef_a = jnp.sum(a[..., None] * oh, axis=-2)      # [..., 1024]
    coef_b = jnp.sum(b[..., None] * oh, axis=-2)
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(coef_a, cos_t, precision=hi)
            + jnp.matmul(coef_b, sin_t, precision=hi))


def _amp_of(planes):
    amp = 2.0 ** ((planes["amp_sf"].astype(jnp.float32) - 3.0) / 4.0)
    return jnp.where(planes["valid"], amp, 0.0)


def _synth_own(freq, ph, sf, valid, length=128):
    amp = jnp.where(valid, 2.0 ** ((sf.astype(jnp.float32) - 3.0) / 4.0), 0.0)
    return _wave_sum(freq, ph, amp, 0, length)


@lru_cache(maxsize=None)
def _dft_mats():
    """[128, 1024] cos/sin DFT matrices for the zero-padded 2048-point
    spectrum on the 10-bit FreqIndex grid (bins 0..1023).

    The lane signal is 128 samples, so the padded rFFT the estimator needs
    is exactly one [128, 1024] matmul pair instead of an FFT over 16x zero
    padding.
    """
    n = np.arange(128)[:, None]
    k = np.arange(1024)[None, :]
    ang = 2.0 * np.pi * n * k / 2048.0
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _lane_spectrum(x):
    """x [L, 128] -> (re, im) [L, 1024]: X[k] = sum_n x[n] e^{-2pi i nk/2048}
    for k = 0..1023 (f32-exact matmul; bin 1024 is excluded by the
    estimator's mask anyway)."""
    c, s = _dft_mats()
    hi = jax.lax.Precision.HIGHEST
    re = jnp.dot(x, jnp.asarray(c), precision=hi)
    im = -jnp.dot(x, jnp.asarray(s), precision=hi)
    return re, im


def _greedy(x, fit_mask, max_keep, sb_ath):
    """Greedy per-lane sinusoid extraction.

    x: [L, 128] lane signals; fit_mask: [L, 128] bool fit window;
    max_keep: [L] int32 cap on accepted waves; sb_ath: [L] power gates.
    Returns freq, sf, ph [L, MAX_WAVES] int32 and valid [L, MAX_WAVES].
    """
    lanes = x.shape[0]
    xm = jnp.where(fit_mask, x, 0.0)
    n_fit = jnp.maximum(jnp.sum(fit_mask, axis=-1), 1).astype(jnp.float32)
    bins_mask = jnp.arange(1024) >= 1           # DC out; 1024 not computed

    def round_fn(k, carry):
        x, freq, sf, ph, valid, done, max_amp = carry
        re, im = _lane_spectrum(x)                  # [L, 1024]
        mag2 = jnp.where(bins_mask, re * re + im * im, 0.0)
        b = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
        pick = lambda a: jnp.take_along_axis(a, b[:, None], axis=-1)[:, 0]
        re_b, im_b = pick(re), pick(im)
        amp = 2.0 * jnp.sqrt(re_b * re_b + im_b * im_b) / n_fit
        # x ~ A sin(w i + phi): phi = angle(X) + pi/2
        phi = jnp.arctan2(im_b, re_b) + np.pi / 2.0
        phi_steps = jnp.mod(phi * (2048.0 / (2.0 * np.pi)), 2048.0)

        sf_k, amp_q, ph_k = _quantize_wave(amp, phi_steps,
                                           b.astype(jnp.float32))
        i128 = jnp.arange(128)
        pos = ((ph_k[:, None] << 6) + i128 * b[:, None]) & 2047
        tone = jnp.where(fit_mask, amp_q[:, None] * jnp.sin(
            2.0 * np.pi * pos.astype(jnp.float32) / 2048.0), 0.0)

        e_old = jnp.sum(x * x, axis=-1)
        resid = x - tone
        e_new = jnp.sum(resid * resid, axis=-1)

        # distance to already-accepted tones (DoRound's 20-bin guard)
        dist = jnp.where(valid, jnp.abs(freq - b[:, None]), 1 << 20)
        far_enough = jnp.min(dist, axis=-1) >= MIN_FREQ_DIST
        gates = ((e_new < e_old * _ACCEPT_RATIO)
                 & (amp * amp > sb_ath)              # PsyPreCheck: ATH
                 & (amp > max_amp / 10.0)            # PsyPreCheck: -23 dB
                 & far_enough
                 & (k < max_keep))
        accept = ~done & gates
        done = done | ~gates                         # any failure stops lane

        x = jnp.where(accept[:, None], resid, x)
        freq = freq.at[:, k].set(jnp.where(accept, b, 0))
        sf = sf.at[:, k].set(jnp.where(accept, sf_k, 0))
        ph = ph.at[:, k].set(jnp.where(accept, ph_k, 0))
        valid = valid.at[:, k].set(accept)
        max_amp = jnp.where(accept, jnp.maximum(max_amp, amp), max_amp)
        return x, freq, sf, ph, valid, done, max_amp

    init = (xm, jnp.zeros((lanes, MAX_WAVES), jnp.int32),
            jnp.zeros((lanes, MAX_WAVES), jnp.int32),
            jnp.zeros((lanes, MAX_WAVES), jnp.int32),
            jnp.zeros((lanes, MAX_WAVES), bool),
            jnp.zeros((lanes,), bool),
            jnp.zeros((lanes,), jnp.float32))
    _, freq, sf, ph, valid, _, _ = jax.lax.fori_loop(
        0, MAX_WAVES, round_fn, init)
    return freq, sf, ph, valid


def _detect_run(x, resid):
    """Longest run of 4-sample blocks where rms_in >= rms_out
    (CheckResuidalAndApply, at3p_gha.cpp:510-538).  [L,128] -> start, end in
    samples (end exclusive); empty run -> (0, 0)."""
    ei = jnp.sqrt(jnp.mean(x.reshape(-1, 32, 4) ** 2, axis=-1))
    eo = jnp.sqrt(jnp.mean(resid.reshape(-1, 32, 4) ** 2, axis=-1))
    ok = ei >= eo                                    # [L, 32]

    def step(carry, ok_i):
        cur_len, cur_start, best_len, best_start, idx = carry
        cur_start = jnp.where(ok_i & (cur_len == 0), idx, cur_start)
        cur_len = jnp.where(ok_i, cur_len + 1, 0)
        better = cur_len > best_len
        best_len = jnp.where(better, cur_len, best_len)
        best_start = jnp.where(better, cur_start, best_start)
        return (cur_len, cur_start, best_len, best_start, idx + 1), None

    lanes = x.shape[0]
    z = jnp.zeros((lanes,), jnp.int32)
    (_, _, blen, bstart, _), _ = jax.lax.scan(
        step, (z, z, z, z, jnp.zeros((), jnp.int32)), jnp.swapaxes(ok, 0, 1))
    return bstart * 4, (bstart + blen) * 4


def extract(bands):
    """Full GHA analysis, subband strategy (TSubbandGhaProcessor): greedy
    per-subband tones + envelopes + stereo merge.

    bands: [C, F, 16, 128] PQF band samples (content frames).
    Returns wire-effective planes (see module docstring).
    """
    x = bands[..., :NUM_TONE_SUBBANDS, :].reshape((-1, 128))  # [L, 128]
    lanes = x.shape[0]
    sb_ath = jnp.tile(jnp.asarray(_SUBBAND_ATH), lanes // NUM_TONE_SUBBANDS)

    full = jnp.ones((lanes, 128), bool)
    cap = jnp.full((lanes,), MAX_WAVES, jnp.int32)
    freq, sf, ph, valid = _greedy(x, full, cap, sb_ath)

    def refit(mask2, truncate, n1):
        return _greedy(x, jnp.where(truncate[:, None], mask2, full),
                       jnp.where(truncate, n1, cap), sb_ath)

    return _finish(bands, x, freq, sf, ph, valid, refit)


def _finish(bands, x, freq, sf, ph, valid, refit=None):
    """Shared analysis tail: 48-tone budget, envelope detection (with an
    optional truncated-window refit), next-frame continuation, wire envelope
    encoding, stereo merge."""
    c, f = bands.shape[0], bands.shape[1]

    # global tone budget per frame (ApplyFilter's 48-tone wire limit):
    # keep the strongest waves across channels/subbands
    amp_all = jnp.where(valid,
                        2.0 ** ((sf.astype(jnp.float32) - 3.0) / 4.0), 0.0)
    amp_fr = amp_all.reshape(c, f, NUM_TONE_SUBBANDS * MAX_WAVES)
    amp_fr = jnp.swapaxes(amp_fr, 0, 1).reshape(f, -1)     # [F, C*8*W]
    order = jnp.argsort(-amp_fr, axis=-1)
    ranks = jnp.zeros_like(order).at[
        jnp.arange(f)[:, None], order].set(jnp.arange(order.shape[-1]))
    keep_fr = ranks < MAX_TOTAL_TONES                      # [F, C*8*W]
    keep = jnp.swapaxes(
        keep_fr.reshape(f, c, NUM_TONE_SUBBANDS, MAX_WAVES), 0, 1)
    valid = valid & keep.reshape(-1, MAX_WAVES)

    # envelope pass 1: run-detect on the fit residual
    resid1 = x - _synth_own(freq, ph, sf, valid)
    s1, e1 = _detect_run(x, resid1)
    has = jnp.any(valid, axis=-1)
    reject1 = has & (e1 - s1 < 16)                   # len < 4 blocks: Error
    truncate = has & ~reject1 & (e1 < 128)

    if refit is not None:
        # envelope pass 2: refit on the truncated window (FrameSz=end
        # Repeat, CheckResuidalAndApply at3p_gha.cpp:548-552)
        n1 = jnp.sum(valid, axis=-1).astype(jnp.int32)
        mask2 = jnp.arange(128) < e1[:, None]
        freq2, sf2, ph2, valid2 = refit(mask2, truncate, n1)
        t = truncate[:, None]
        freq = jnp.where(t, freq2, freq)
        sf = jnp.where(t, sf2, sf)
        ph = jnp.where(t, ph2, ph)
        valid = jnp.where(t, valid2, valid)
        resid2 = x - _synth_own(freq, ph, sf, valid)
        s2, e2 = _detect_run(x, resid2)
        has2 = jnp.any(valid, axis=-1)
        reject = (has2 & truncate & (e2 - s2 < 16)) | (reject1 & ~truncate)
        start = jnp.where(truncate, s2, s1)
        end = jnp.where(truncate, e2, 128)
    else:
        reject = reject1
        start, end = s1, jnp.where(truncate, e1, 128)
    valid = valid & ~reject[:, None]
    has = jnp.any(valid, axis=-1)

    # continuation into the next frame (CheckNextFrame): tone set extended
    # over the next frame's first 64 samples must reduce its energy
    amp_q = jnp.where(valid,
                      2.0 ** ((sf.astype(jnp.float32) - 3.0) / 4.0), 0.0)
    ext = _wave_sum(freq, ph, amp_q, 128, length=64)  # continues past frame
    shp = (c, f, NUM_TONE_SUBBANDS, 128)
    x_next = jnp.pad(bands[..., :NUM_TONE_SUBBANDS, :].reshape(shp)[:, 1:],
                     ((0, 0), (0, 1), (0, 0), (0, 0))).reshape(-1, 128)
    nxt = x_next[:, :64]
    e_before = jnp.sum(nxt * nxt, axis=-1)
    diff = nxt - ext
    e_after = jnp.sum(diff * diff, axis=-1)
    cont = e_after < e_before

    # wire envelope (AdjustEnvelope, at3p_gha.cpp:1499-1521): stop point
    # absent for gapless full-length tones, else (end-1)/4; start point
    # absent only when the run starts at 0 AND the previous frame's wire
    # envelope had no stop point
    gapless = has & (end == 128) & cont
    env_stop = jnp.where(has & ~gapless, end // 4 - 1, -1)
    sh = (c, f, NUM_TONE_SUBBANDS)
    stop_present = (env_stop >= 0).reshape(sh)
    prev_stop = jnp.pad(stop_present[:, :-1], ((0, 0), (1, 0), (0, 0)))
    start_flat = start
    has_sh = has.reshape(sh)
    start_present = has_sh & ((start_flat.reshape(sh) > 0) | prev_stop)
    env_start = jnp.where(start_present, start_flat.reshape(sh) // 4, -1)

    out_shape = (c, f, NUM_TONE_SUBBANDS, MAX_WAVES)
    planes = {"freq": freq.reshape(out_shape),
              "amp_sf": sf.reshape(out_shape),
              "phase": ph.reshape(out_shape),
              "valid": valid.reshape(out_shape),
              "env_start": env_start.astype(jnp.int32),
              "env_stop": env_stop.reshape(sh).astype(jnp.int32)}
    return _merge_stereo(planes)


WB_ROUNDS = 12              # matching-pursuit extraction rounds per frame
WB_PROJECT_GATE = 0.02      # -34 dB relative to the home subband's response
WB_DECAY_STOP = 1.0 / 32.0  # stop once tones decay ~30 dB below the peak


def _pqf_response(omega):
    """Complex response of the analysis PQF per subband at raw-domain
    frequency `omega` [L] (rad/sample): H[sb](w) = sum_p K[sb,p] e^{iwp}.

    The reference ships a generated calibration table measured by probing
    the real PQF (at3p_pqf_wideband_table.h, 6435 lines, built by
    tools/pqf_wideband_calibrate.cpp); with the filterbank expressed as one
    [16, 384] kernel the response is available in closed form instead.
    Returns [L, 16] complex64.
    """
    from . import pqf
    kern = jnp.asarray(pqf._analysis_kernel())             # [16, 384]
    p = jnp.arange(384)
    e = jnp.exp(1j * omega[:, None].astype(jnp.complex64) * p)
    return jnp.matmul(e, kern.T.astype(jnp.complex64),     # [L, 16]
                      precision=jax.lax.Precision.HIGHEST)


def _wb_band_params(omega, amp, phi, h):
    """Project a raw-domain tone (omega, amp, phase-at-frame-start) through
    one subband's complex response h.  Returns (freq_index, band_amp,
    band_phase_steps) on the wire grid; the band signal is
    amp*|h| * sin(16w n + phi - 368w + arg h)  (the analysis convolution
    left-pads 368 samples), reflected into [0, pi) when 16w aliases."""
    band_amp = amp * jnp.abs(h)
    psi = phi - 368.0 * omega + jnp.angle(h)
    big_omega = jnp.mod(16.0 * omega, 2.0 * np.pi)
    refl = big_omega > np.pi
    omega_f = jnp.where(refl, 2.0 * np.pi - big_omega, big_omega)
    psi = jnp.where(refl, np.pi - psi, psi)
    f_idx = jnp.clip(jnp.round(omega_f * (2048.0 / (2.0 * np.pi))),
                     0, 1023).astype(jnp.int32)
    phi_steps = jnp.mod(psi * (2048.0 / (2.0 * np.pi)), 2048.0)
    return f_idx, band_amp, phi_steps


def extract_wideband(bands, raw, refine_raw=False):
    """Wideband GHA strategy (TWidebandGhaProcessor, at3p_gha.cpp:975-1497):
    matching pursuit on the raw 2048-sample frames, analytic projection of
    each tone into its home subband +-1 through the PQF response, then the
    shared envelope/merge tail.

    raw: [C, F, 2048] raw PCM frames (same scale as the PQF input);
    refine_raw: True keeps the projected amplitude/phase (--advanced
    ghawbrefine=1 "raw"); False re-estimates them from the subband signal
    (ghawbrefine=0 "subband", the default).
    """
    c, f = bands.shape[0], bands.shape[1]
    lanes = c * f
    # raw stays in input scale: the PQF kernel's own gain (x32768) is part
    # of the projected response H, so band_amp = amp_raw * |H| lands in the
    # band domain directly
    x = raw.reshape(lanes, 2048)
    tgrid = jnp.arange(2048)
    bin_mask = (jnp.arange(2049) >= 2) & (jnp.arange(2049) <= 2046)

    def round_fn(k, carry):
        x, cand, max_amp = carry
        spec = jnp.fft.rfft(x, n=4096)
        mag = jnp.where(bin_mask, jnp.abs(spec), 0.0)
        b = jnp.argmax(mag, axis=-1)
        take = lambda o: jnp.log(jnp.take_along_axis(
            mag, (b + o)[:, None], axis=-1)[:, 0] + 1e-30)
        a0, a1, a2 = take(-1), take(0), take(1)
        denom = a0 - 2.0 * a1 + a2
        delta = jnp.clip(jnp.where(jnp.abs(denom) > 1e-9,
                                   0.5 * (a0 - a2) / denom, 0.0), -0.5, 0.5)
        omega = (b.astype(jnp.float32) + delta) * (2.0 * np.pi / 4096.0)

        # exact complex projection at the refined frequency
        e = jnp.exp(-1j * omega[:, None].astype(jnp.complex64) * tgrid)
        proj = jnp.sum(x.astype(jnp.complex64) * e, axis=-1)
        amp = 2.0 * jnp.abs(proj) / 2048.0
        phi = jnp.angle(proj) + np.pi / 2.0

        home = jnp.clip((omega * (16.0 / np.pi)).astype(jnp.int32), 0, 15)
        in_range = omega < (np.pi / 2.0)          # 11025 Hz: subbands 0..7
        alive = in_range & (amp > max_amp * WB_DECAY_STOP)
        max_amp = jnp.maximum(max_amp, jnp.where(alive, amp, 0.0))

        h_all = _pqf_response(omega)              # [L, 16]
        h_home = jnp.take_along_axis(jnp.abs(h_all), home[:, None],
                                     axis=-1)[:, 0]
        for slot, off in enumerate((-1, 0, 1)):
            sb = home + off
            ok_sb = (sb >= 0) & (sb < NUM_TONE_SUBBANDS)
            sb_c = jnp.clip(sb, 0, 15)
            h = jnp.take_along_axis(h_all, sb_c[:, None], axis=-1)[:, 0]
            f_idx, b_amp, ph_steps = _wb_band_params(omega, amp, phi, h)
            gate = (alive & ok_sb
                    & (jnp.abs(h) >= WB_PROJECT_GATE * h_home)
                    & (b_amp * b_amp
                       > jnp.asarray(_SUBBAND_ATH)[jnp.clip(sb, 0, 7)]))
            j = k * 3 + slot
            cand["sb"] = cand["sb"].at[:, j].set(jnp.where(gate, sb, -1))
            cand["freq"] = cand["freq"].at[:, j].set(f_idx)
            cand["amp"] = cand["amp"].at[:, j].set(
                jnp.where(gate, b_amp, 0.0))
            cand["phs"] = cand["phs"].at[:, j].set(ph_steps)

        # remove the fitted tone from the pursuit scratch
        tone = amp[:, None] * jnp.sin(omega[:, None] * tgrid + phi[:, None])
        x = jnp.where(alive[:, None], x - tone, x)
        return x, cand, max_amp

    ncand = WB_ROUNDS * 3
    cand = {"sb": jnp.full((lanes, ncand), -1, jnp.int32),
            "freq": jnp.zeros((lanes, ncand), jnp.int32),
            "amp": jnp.zeros((lanes, ncand), jnp.float32),
            "phs": jnp.zeros((lanes, ncand), jnp.float32)}
    _, cand, _ = jax.lax.fori_loop(
        0, WB_ROUNDS, round_fn,
        (x, cand, jnp.zeros((lanes,), jnp.float32)))

    # bucket candidates into per-subband wave slots (strongest first, with
    # the 20-bin minimum distance guard)
    sb_axis = jnp.arange(NUM_TONE_SUBBANDS)
    in_sb = cand["sb"][:, None, :] == sb_axis[None, :, None]  # [L, 8, NC]
    amp_sb = jnp.where(in_sb, cand["amp"][:, None, :], 0.0)
    order = jnp.argsort(-amp_sb, axis=-1)                  # [L, 8, NC]
    freq_s = jnp.take_along_axis(
        jnp.broadcast_to(cand["freq"][:, None, :], amp_sb.shape), order, -1)
    phs_s = jnp.take_along_axis(
        jnp.broadcast_to(cand["phs"][:, None, :], amp_sb.shape), order, -1)
    amp_s = jnp.take_along_axis(amp_sb, order, -1)
    valid_s = amp_s > 0.0
    # distance guard against every stronger candidate
    d = jnp.abs(freq_s[..., :, None] - freq_s[..., None, :])
    earlier = (jnp.arange(ncand)[None, :] < jnp.arange(ncand)[:, None])
    clash = (d < MIN_FREQ_DIST) & earlier & valid_s[..., None, :]
    valid_s = valid_s & ~clash.any(-1)
    # compact to the first MAX_WAVES surviving slots
    pos = jnp.cumsum(valid_s, axis=-1) - 1
    sel = jnp.where(valid_s, pos, ncand)
    w = jnp.arange(MAX_WAVES)
    hit = sel[..., None, :] == w[:, None]                  # [L,8,W,NC]
    pick = lambda a: jnp.sum(jnp.where(hit, a[..., None, :], 0), axis=-1)
    freq_w = pick(freq_s).astype(jnp.int32)
    amp_w = pick(amp_s)
    phs_w = pick(phs_s)
    valid_w = hit.any(-1)

    band_x = bands[..., :NUM_TONE_SUBBANDS, :].reshape(-1, 128)
    if not refine_raw:
        # "subband" refine: re-estimate amplitude/phase from the band signal
        # at the quantized frequency (the reference's default Newton refine
        # in the subband domain, at3p_gha.cpp:1206-1288)
        m = jnp.arange(128)
        lw = freq_w.reshape(lanes * NUM_TONE_SUBBANDS, MAX_WAVES)
        bx = band_x[:, None, :]                            # [L8, 1, 128]
        ang = lw[..., None].astype(jnp.float32) * m * (2.0 * np.pi / 2048.0)
        proj = jnp.sum(bx * jnp.exp(-1j * ang.astype(jnp.complex64)), -1)
        amp_r = 2.0 * jnp.abs(proj) / 128.0
        phs_r = jnp.mod((jnp.angle(proj) + np.pi / 2.0)
                        * (2048.0 / (2.0 * np.pi)), 2048.0)
        amp_w = amp_r.reshape(amp_w.shape)
        phs_w = phs_r.reshape(phs_w.shape)

    sf_w, _, ph_w = _quantize_wave(amp_w, phs_w, freq_w.astype(jnp.float32))
    shape = (lanes * NUM_TONE_SUBBANDS, MAX_WAVES)
    freq_w = freq_w.reshape(shape)
    sf_w = sf_w.reshape(shape)
    ph_w = ph_w.reshape(shape)
    valid_w = valid_w.reshape(shape)
    # ATH/psy gate after refine, against the quantized amplitude
    amp_q = 2.0 ** ((sf_w.astype(jnp.float32) - 3.0) / 4.0)
    ath = jnp.tile(jnp.asarray(_SUBBAND_ATH),
                   lanes)[:, None]
    valid_w = valid_w & (amp_q * amp_q > ath.reshape(-1, 1))

    return _finish(bands, band_x, freq_w, sf_w, ph_w, valid_w, refit=None)


def _merge_stereo(planes):
    """Leader/follower + tone sharing (FillResultBuf / FillFolowerRes).

    Makes planes wire-effective: for shared subbands the follower channel's
    slots are replaced by the leader's waves AND envelope (ApplyFilter
    copies tones_info wholesale, at3p_gha.cpp:655-658); follower waves in
    subbands >= the leader's NumToneBands are dropped (never written).
    """
    c, f = planes["valid"].shape[:2]
    sb_idx = jnp.arange(NUM_TONE_SUBBANDS)
    any_sb = planes["valid"].any(-1)                       # [C, F, 8]
    nb_used = jnp.max(jnp.where(any_sb, sb_idx + 1, 0), axis=-1)  # [C, F]
    if c == 1:
        planes["sharing"] = jnp.zeros((f, NUM_TONE_SUBBANDS), bool)
        planes["leader"] = jnp.zeros((f,), jnp.int32)
        return planes

    leader = (nb_used[1] > nb_used[0]).astype(jnp.int32)   # [F]
    nb = jnp.take_along_axis(nb_used, leader[None], axis=0)[0]  # [F]

    # drop waves above the leader's band range
    in_range = sb_idx[None, :] < nb[:, None]               # [F, 8]
    planes["valid"] = planes["valid"] & in_range[None, :, :, None]
    any_sb = planes["valid"].any(-1)

    def pick(x, ch_sel):
        """x: [C, F, ...] -> per-frame channel select."""
        sel = ch_sel.reshape((1, -1) + (1,) * (x.ndim - 2))
        return jnp.take_along_axis(x, sel, axis=0)[0]

    lead = {k: pick(planes[k], leader) for k in
            ("freq", "amp_sf", "phase", "valid", "env_start", "env_stop")}
    fol = {k: pick(planes[k], 1 - leader) for k in
           ("freq", "amp_sf", "phase", "valid", "env_start", "env_stop")}

    # sharing: every follower wave's freq exists in the leader's set
    fol_freq = jnp.where(fol["valid"], fol["freq"], -1)    # [F, 8, W]
    match = (fol_freq[..., :, None]
             == jnp.where(lead["valid"], lead["freq"], -2)[..., None, :])
    covered = jnp.all(match.any(-1) | ~fol["valid"], axis=-1)  # [F, 8]
    sharing = covered & fol["valid"].any(-1) & lead["valid"].any(-1)

    # wire-effective follower = leader's data on shared subbands
    sh_w = sharing[..., None]
    new_fol = {k: jnp.where(sh_w if fol[k].ndim == 3 else sharing,
                            lead[k], fol[k])
               for k in fol}

    # scatter leader/follower back to physical channel slots
    out = {}
    for k in lead:
        l, fo = lead[k], new_fol[k]
        is_l = (jnp.arange(2).reshape((2,) + (1,) * l.ndim)
                == leader.reshape((1, -1) + (1,) * (l.ndim - 1)))
        out[k] = jnp.where(is_l, l[None], fo[None])
    out["sharing"] = sharing
    out["leader"] = leader
    return out


# --- decoder-faithful synthesis (ff_atrac3p_generate_tones) -----------------

def _curr_env(planes):
    """Reconstruct the full two-frame envelope for each wave block
    (generate_tones, atrac3plusdsp.c:148-171).  pend(c) is block c's wire
    envelope, pend(c-1) the previous block's; positions are 4-sample units
    spanning [0,32) = the block's region-2 frame, [32,64) = its region-1
    frame.  Returns has_start, start, has_stop, stop: [C, F, 8] int32."""
    sp = planes["env_start"] >= 0
    sv = jnp.where(sp, planes["env_start"], -1)
    tp = planes["env_stop"] >= 0
    tv = jnp.where(tp, planes["env_stop"], 32)

    def prev(a, fill):
        return jnp.pad(a[:, :-1], ((0, 0), (1, 0), (0, 0)),
                       constant_values=fill)

    sp_p, sv_p = prev(sp, False), prev(sv, -1)
    tp_p, tv_p = prev(tp, False), prev(tv, 32)

    r1 = sp & (sv < tv)
    has_start = r1 | sp_p
    start = jnp.where(r1, sv + 32, jnp.where(sp_p, sv_p, 0))

    r2 = tp_p & (tv_p >= start)
    has_stop = r2 | tp
    stop = jnp.where(r2, tv_p, jnp.where(tp, tv + 32, 64))
    return has_start, start, has_stop, stop


def _env_mask(has_start, start, has_stop, stop, reg_offset):
    """waves_synth's fade-in/out multiplicative mask over 128 samples
    (atrac3plusdsp.c:109-135).  All args [..., 1]-broadcastable ints."""
    i = jnp.arange(128)
    hann = (1.0 - np.cos(2.0 * np.pi * np.arange(256) / 256.0)) * 0.5
    hq = hann[[0, 32, 64, 96]].astype(np.float32)          # rising quarter

    def hq_at(j):
        # 4-entry ramp select as step arithmetic instead of a
        # per-element gather into the table
        return jnp.where(j <= 0, float(hq[0]),
                         jnp.where(j == 1, float(hq[1]),
                                   jnp.where(j == 2, float(hq[2]),
                                             float(hq[3]))))

    pos = (start << 2) - reg_offset
    fade_in = has_start & (pos > 0) & (pos <= 128)
    edge = ~(has_stop & (start == stop))
    j = i - pos[..., None]
    m_in = jnp.where(fade_in[..., None],
                     jnp.where(j < 0, 0.0,
                               jnp.where(edge[..., None] & (j < 4),
                                         hq_at(j), 1.0)),
                     1.0)

    pos2 = ((stop + 1) << 2) - reg_offset
    fade_out = has_stop & (pos2 > 0) & (pos2 <= 128)
    k = i - (pos2[..., None] - 4)
    m_out = jnp.where(fade_out[..., None],
                      jnp.where(k < 0, 1.0,
                                jnp.where(k < 4, hq_at(3 - k),
                                          0.0)),
                      1.0)
    return m_in * m_out


def synthesize(planes):
    """The decoder's tone signal in content-frame alignment: content frame c
    receives the enveloped falling half of its own waves (region 1) plus the
    enveloped rising half of frame c+1's (region 2), with generate_tones'
    crossfade-suppression rules.  Returns [C, F, 8, 128]."""
    hann = (1.0 - jnp.cos(2.0 * np.pi * jnp.arange(256) / 256.0)) * 0.5
    rise, fall = hann[:128], hann[128:]

    amp = _amp_of(planes)
    reg1_raw = _wave_sum(planes["freq"], planes["phase"], amp, 0)
    reg2_raw = _wave_sum(planes["freq"], planes["phase"], amp, -128)

    has_start, start, has_stop, stop = _curr_env(planes)
    m1 = _env_mask(has_start, start, has_stop, stop, 128)
    m2 = _env_mask(has_start, start, has_stop, stop, 0)
    reg1 = reg1_raw * m1
    reg2 = reg2_raw * m2

    nw = planes["valid"].any(-1)
    reg1_nz = nw & ~(stop < 32)                      # visible in own frame
    reg2_nz = nw & ~(start >= 32)                    # visible in prev frame

    def nxt(a, fill=False):
        pad = ((0, 0), (0, 1)) + ((0, 0),) * (a.ndim - 2)
        return jnp.pad(a[:, 1:], pad, constant_values=fill)

    # crossfade rules (atrac3plusdsp.c:190-200) at content frame c:
    # region 1 = block c, region 2 = block c+1
    both = reg1_nz & nxt(reg2_nz)
    r1_hann = both | (nw & ~has_stop)
    r2_hann_own = nw & ~has_start                    # for block c+1's reg2
    r1 = jnp.where(reg1_nz[..., None],
                   jnp.where(r1_hann[..., None], reg1 * fall, reg1), 0.0)
    r2_all = jnp.where(reg2_nz[..., None], reg2, 0.0)
    r2_next = nxt(r2_all, 0.0)
    r2_scaled = jnp.where((both | nxt(r2_hann_own))[..., None],
                          r2_next * rise, r2_next)
    return r1 + r2_scaled


def subtract(bands, planes):
    """Residual = bands minus the decoder's tone synthesis.

    bands [C, F, 16, 128]; planes from extract() (wire-effective)."""
    synth = synthesize(planes)
    res_tone_bands = bands[..., :NUM_TONE_SUBBANDS, :] - synth
    return jnp.concatenate(
        [res_tone_bands, bands[..., NUM_TONE_SUBBANDS:, :]], axis=-2)
