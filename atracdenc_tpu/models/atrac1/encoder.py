"""ATRAC1 encoder: whole-track, batched, jit-compiled.

Pipeline per channel (reference call stack: src/atrac1denc.cpp:180-255):
  QMF analysis -> per-band transient detection -> windowed MDCT ->
  loudness tracking (scan) -> block-floating scale -> bit allocation ->
  mantissa quantization.
The output is a set of fixed-shape integer planes; host code (frame.py)
serializes them into 212-byte sound units.
"""
from functools import partial

import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from atracdenc_tpu.ops import psy, scale as scale_ops
from atracdenc_tpu.ops.transient import transient_mask
from . import tables as T
from . import filterbank
from .mdct import mdct_frames
from .bitalloc import allocate

_LOUD_CURVE = _npc(np.asarray(psy.create_loudness_curve(T.NUM_SAMPLES)))
_GATHER_LONG = _npc(np.asarray(T.GATHER_LONG))
_GATHER_SHORT = _npc(np.asarray(T.GATHER_SHORT))
_GATHER_MASK = _npc(np.asarray(T.GATHER_MASK))
_BFU_TO_BAND = _npc(np.asarray(T.BFU_TO_BAND))


def _invert_spectrum(x):
    """Negate even-indexed samples (util.h:51-63); frames are even-length so
    the per-frame pattern equals the whole-track pattern."""
    sign = jnp.where(jnp.arange(x.shape[-1]) % 2 == 0, -1.0, 1.0).astype(x.dtype)
    return x * sign


def _blocks_static(specs, start_tab):
    """[..., 512] -> [..., 52, 20] padded BFU blocks for one (static) line
    layout — every BFU's lines are a contiguous run, so this is a slice/pad
    composition, not a gather."""
    parts = []
    for b in range(T.MAX_BFUS):
        s = int(start_tab[b, 0])
        n = int(T.SPECS_PER_BLOCK[b])
        parts.append(jnp.pad(specs[..., s:s + n],
                             [(0, 0)] * (specs.ndim - 1) + [(0, 20 - n)]))
    return jnp.stack(parts, axis=-2)


def gather_bfu_blocks(specs, short_flags):
    """[..., 512] spectra -> padded BFU blocks [..., 52, 20].

    short_flags: [..., 3] bool per band; selects short/long line layout
    (atrac_scale.cpp:175-188).  Both layouts are static slice compositions;
    the per-BFU choice is a select, not a gather.
    """
    long_b = _blocks_static(specs, T.GATHER_LONG)
    short_b = _blocks_static(specs, T.GATHER_SHORT)
    short_per_bfu = sum(
        short_flags[..., band, None] * (np.asarray(T.BFU_TO_BAND) == band)
        for band in range(3))                         # [..., 52] bool-ish
    return jnp.where(short_per_bfu[..., None].astype(bool),
                     short_b, long_b) * _GATHER_MASK


@partial(jax.jit, static_argnames=("bfu_idx_const", "window_mode",
                                   "window_mask"))
def encode_frames(pcm, bfu_idx_const=0, window_mode="auto", window_mask=0):
    """Encode [C, T] PCM (T multiple of 512) into ATRAC1 frame planes.

    Returns dict of planes:
      short_mask [C, F, 3] bool, bfu_idx [C, F], wordlen [C, F, 52],
      sfi [C, F, 52], mant [C, F, 52, 20] — all int32/bool.
    """
    c, t = pcm.shape
    f = t // T.NUM_SAMPLES

    low, mid, hi = filterbank.analysis(pcm)

    if window_mode == "auto":
        m_low = transient_mask(low, 128)
        m_mid = transient_mask(_invert_spectrum(mid), 128)
        m_hi = transient_mask(_invert_spectrum(hi), 256)
        masks = jnp.stack([m_low, m_mid, m_hi], axis=-1)      # [C, F, 3]
    else:
        masks = jnp.broadcast_to(
            jnp.asarray([bool(window_mask & 1), bool(window_mask & 2),
                         bool(window_mask & 4)]), (c, f, 3))

    specs = jnp.concatenate([
        mdct_frames(low.reshape(c, f, 128), masks[..., 0], 0),
        mdct_frames(mid.reshape(c, f, 128), masks[..., 1], 1),
        mdct_frames(hi.reshape(c, f, 256), masks[..., 2], 2),
    ], axis=-1)                                               # [C, F, 512]

    # loudness IIR across frames (atrac1denc.cpp:235-247)
    frame_loud = jnp.sum(specs * specs * _LOUD_CURVE, axis=-1)  # [C, F]
    mask_any = jnp.any(masks, axis=-1)                          # [C, F]
    if c == 2:
        use_both = ~mask_any[0] & ~mask_any[1]
        use_one = ~mask_any[0] & ~use_both
        l0, l1 = frame_loud[0], frame_loud[1]
    else:
        use_both = jnp.zeros((f,), bool)
        use_one = ~mask_any[0]
        l0 = frame_loud[0]
        l1 = jnp.zeros_like(l0)
    loud = psy.track_loudness_scan(l0, l1, use_both, use_one, T.LOUD_FACTOR)
    loud = jnp.broadcast_to(loud / T.LOUD_FACTOR, (c, f))

    blocks = gather_bfu_blocks(specs, masks)                  # [C, F, 52, 20]
    sfi, scaled, energy = scale_ops.scale_blocks(
        blocks, _GATHER_MASK, jnp.asarray(T.SCALE_TABLE))

    with jax.named_scope("rate_control"):
        bfu_idx, wordlen = allocate(sfi, energy, masks, loud,
                                    bfu_idx_const=bfu_idx_const)
    mant = scale_ops.quant_mantissas(scaled, wordlen)

    # operator feedback: |spec| > MAX_SCALE is exactly where the reference
    # clamps + warns (atrac_scale.cpp:150-167); the batched pipeline
    # aggregates counts instead of printing per value
    absb = jnp.abs(blocks)
    return {
        "short_mask": masks,
        "bfu_idx": bfu_idx.astype(jnp.int32),
        "wordlen": wordlen,
        "sfi": sfi,
        "mant": mant,
        "clip_count": jnp.sum(absb > 1.0, axis=(-1, -2)).astype(jnp.int32),
        "clip_max": jnp.max(jnp.max(absb, -1), -1),
    }


CHUNK_LEFT = 3    # context frames: QMF-tree FIR reach (~140 samples) +
                  # MDCT prev-half + transient prev-block, each <= 1 frame
CHUNK_RIGHT = 1   # the transient HPF reads 1 sample past the frame


@partial(jax.jit, static_argnames=("bfu_idx_const", "window_mode",
                                   "window_mask", "first"))
def _encode_window(pcm_ext, loud_init, bfu_idx_const=0, window_mode="auto",
                   window_mask=0, first=False):
    """Chunk core: pcm_ext [C, (CHUNK_LEFT + f + 1) * 512] -> (planes for
    the f content frames, raw loudness carry).  Context frames pin the
    filterbank/transient/MDCT couplings; the loudness IIR (the only true
    unbounded recurrence) enters through loud_init.  first=True replaces
    the silent-context transient seed with the track-start semantics (the
    reference's initial LastEnergy is 0 dB, transient_detector.h:41)."""
    c, text = pcm_ext.shape
    fe = text // T.NUM_SAMPLES
    f = fe - CHUNK_LEFT - CHUNK_RIGHT

    low, mid, hi = filterbank.analysis(pcm_ext)

    if window_mode == "auto":
        if first:
            # silent context would seed prev-level at -inf dB, not the 0 dB
            # a fresh track starts with — detect over content+lookahead only
            # (the HPF's zero left-padding equals the silent context anyway)
            cut2 = CHUNK_LEFT * 128
            cut4 = CHUNK_LEFT * 256
            m_low = transient_mask(low[..., cut2:], 128)
            m_mid = transient_mask(_invert_spectrum(mid[..., cut2:]), 128)
            m_hi = transient_mask(_invert_spectrum(hi[..., cut4:]), 256)
        else:
            m_low = transient_mask(low, 128)[..., CHUNK_LEFT:]
            m_mid = transient_mask(_invert_spectrum(mid),
                                   128)[..., CHUNK_LEFT:]
            m_hi = transient_mask(_invert_spectrum(hi),
                                  256)[..., CHUNK_LEFT:]
        masks_cl = jnp.stack([m_low, m_mid, m_hi], axis=-1)  # [C, f+1, 3]
    else:
        masks_cl = jnp.broadcast_to(
            jnp.asarray([bool(window_mask & 1), bool(window_mask & 2),
                         bool(window_mask & 4)]), (c, f + 1, 3))
    masks = masks_cl[:, :f]

    # MDCT with one warm-up frame whose stored half seeds the overlap (its
    # own mask only selects its dropped output, so False is fine)
    warm = jnp.zeros((c, 1), bool)
    def band_specs(sig, fsz, col, band):
        bf = sig.reshape(c, fe, fsz)[:, CHUNK_LEFT - 1: CHUNK_LEFT + f]
        m = jnp.concatenate([warm, masks[..., col]], axis=1)
        return mdct_frames(bf, m, band)[:, 1:]
    specs = jnp.concatenate([
        band_specs(low, 128, 0, 0),
        band_specs(mid, 128, 1, 1),
        band_specs(hi, 256, 2, 2),
    ], axis=-1)                                               # [C, f, 512]

    frame_loud = jnp.sum(specs * specs * _LOUD_CURVE, axis=-1)
    mask_any = jnp.any(masks, axis=-1)
    if c == 2:
        use_both = ~mask_any[0] & ~mask_any[1]
        use_one = ~mask_any[0] & ~use_both
        l0, l1 = frame_loud[0], frame_loud[1]
    else:
        use_both = jnp.zeros((f,), bool)
        use_one = ~mask_any[0]
        l0 = frame_loud[0]
        l1 = jnp.zeros_like(l0)
    loud_track = psy.track_loudness_scan(l0, l1, use_both, use_one,
                                         loud_init)
    loud = jnp.broadcast_to(loud_track / T.LOUD_FACTOR, (c, f))

    blocks = gather_bfu_blocks(specs, masks)
    sfi, scaled, energy = scale_ops.scale_blocks(
        blocks, _GATHER_MASK, jnp.asarray(T.SCALE_TABLE))
    with jax.named_scope("rate_control"):
        bfu_idx, wordlen = allocate(sfi, energy, masks, loud,
                                    bfu_idx_const=bfu_idx_const)
    mant = scale_ops.quant_mantissas(scaled, wordlen)
    absb = jnp.abs(blocks)
    planes = {
        "short_mask": masks,
        "bfu_idx": bfu_idx.astype(jnp.int32),
        "wordlen": wordlen,
        "sfi": sfi,
        "mant": mant,
        "clip_count": jnp.sum(absb > 1.0, axis=(-1, -2)).astype(jnp.int32),
        "clip_max": jnp.max(jnp.max(absb, -1), -1),
    }
    return planes, loud_track[-1]


def encode_frames_chunk(pcm, state=None, next_head=None, bfu_idx_const=0,
                        window_mode="auto", window_mask=0):
    """Exact chunked encode: pcm [C, k*512], state = previous-chunk carry
    (None at track start), next_head [C, 512] = the next chunk's first
    frame (None at track end; the transient HPF's one-sample lookahead then
    sees the whole-track zero padding).  Concatenated chunk planes are
    bit-identical to encode_frames on the whole track."""
    pcm = np.asarray(pcm, np.float32)
    c = pcm.shape[0]
    hist_len = CHUNK_LEFT * T.NUM_SAMPLES
    if state is None:
        hist = np.zeros((c, hist_len), np.float32)
        loud_init = float(T.LOUD_FACTOR)
    else:
        hist = state["pcm_tail"]
        loud_init = state["loud"]
    tail = (np.zeros((c, T.NUM_SAMPLES), np.float32) if next_head is None
            else np.asarray(next_head, np.float32))
    ext = np.concatenate([hist, pcm, tail], axis=1)
    planes, loud_last = _encode_window(
        jnp.asarray(ext), jnp.asarray(loud_init, jnp.float32),
        bfu_idx_const=bfu_idx_const, window_mode=window_mode,
        window_mask=window_mask, first=state is None)
    new_state = {"pcm_tail": ext[:, pcm.shape[1]: hist_len + pcm.shape[1]],
                 "loud": loud_last}
    return planes, new_state


def encode_track(pcm: np.ndarray, bfu_idx_const: int = 0,
                 window_mode: str = "auto", window_mask: int = 0,
                 chunk_frames: int = 2048, progress=None):
    """NumPy convenience wrapper: pads to a whole number of frames; long
    tracks encode in exact chunks (bounded device memory); progress:
    optional callback(percent) per chunk (main.cpp:67-74, 704)."""
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    c, t = pcm.shape
    pad = (-t) % T.NUM_SAMPLES
    if pad:
        pcm = np.pad(pcm, ((0, 0), (0, pad)))
    f_total = pcm.shape[1] // T.NUM_SAMPLES

    if chunk_frames and f_total > chunk_frames:
        state = None
        outs = []
        ns = T.NUM_SAMPLES
        for a in range(0, f_total, chunk_frames):
            b = min(a + chunk_frames, f_total)
            nxt = pcm[:, b * ns: (b + 1) * ns] if b < f_total else None
            planes, state = encode_frames_chunk(
                pcm[:, a * ns: b * ns], state, nxt, bfu_idx_const,
                window_mode, window_mask)
            outs.append({k: np.asarray(v) for k, v in planes.items()})
            if progress is not None:
                progress(int(b * 100 / f_total))
        return {k: np.concatenate([o[k] for o in outs], axis=1)
                for k in outs[0]}

    planes = encode_frames(jnp.asarray(pcm), bfu_idx_const=bfu_idx_const,
                           window_mode=window_mode, window_mask=window_mask)
    if progress is not None:
        progress(100)
    return {k: np.asarray(v) for k, v in planes.items()}
