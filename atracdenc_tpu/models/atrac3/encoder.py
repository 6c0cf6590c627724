"""ATRAC3 encoder: whole-track, batched, jit-compiled.

Pipeline per channel (reference call stack: src/atrac3denc.cpp:679-867):
  QMF analysis (4 bands) -> [gain control] -> windowed MDCT with gain
  modulation -> loudness tracking (scan) -> [tonal extraction] ->
  block-floating scale -> lambda-bisection bit allocation -> mantissas.
Output is a set of fixed-shape integer planes; host code (frame.py)
serializes them into the fixed-size sound units.

The one-frame lookahead of the reference (LOOK_AHEAD priming,
atrac3denc.cpp:715-718) exists only because of its streaming gain analysis
window; in whole-track form every frame sees its neighbors directly.
"""
from functools import partial

import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from atracdenc_tpu.ops import psy, scale as scale_ops
from . import tables as T
from . import filterbank
from . import specblocks
from . import tonal
from . import gain
from .mdct import mdct_frames, gain_divisors, first_level_scale
from .bitalloc import quant_tensors, allocate, final_mantissas
from .device_pack import pack_device

_LOUD_CURVE = _npc(np.asarray(psy.create_loudness_curve(1024)))
_GATHER_IDX = _npc(np.asarray(T.GATHER_IDX))
_GATHER_MASK = _npc(np.asarray(T.GATHER_MASK))
_SCALE_TABLE = _npc(np.asarray(T.SCALE_TABLE))


def band_frames(pcm):
    """[C, T] PCM -> [C, F, 4, 256] band samples (input scaled by 1/4,
    reference atrac3denc.cpp:703-705)."""
    c, t = pcm.shape
    f = t // T.NUM_SAMPLES
    bands = filterbank.analysis(pcm * 0.25)          # [C, 4, T/4]
    return jnp.swapaxes(bands.reshape(c, 4, f, 256), 1, 2)


def gather_bfu_blocks(specs):
    """[..., 1024] spectra -> padded BFU blocks [..., 32, 128] (static
    slices — the BFU ranges are contiguous, see specblocks.py)."""
    return specblocks.to_blocks(specs) * _GATHER_MASK


def spread_from_sfi(sfi):
    """AnalizeScaleFactorSpread over all 32 blocks
    (atrac_psy_common.cpp:101-124)."""
    mean = jnp.mean(sfi.astype(jnp.float32), axis=-1)
    var = jnp.mean((sfi - mean[..., None]) ** 2, axis=-1)
    return jnp.minimum(jnp.sqrt(var), 14.0) / 14.0


def init_state(c):
    """Carry state for exact chunked encoding (all reference carries from
    SURVEY.md §3.6 that are true recurrences)."""
    return {
        "gain": gain.init_ctx(c),
        "mdct_prev": jnp.zeros((c, 4, 256), jnp.float32),
        "next_overlap": jnp.ones((c, 4), jnp.float32),
        "loudness": jnp.asarray(T.LOUD_FACTOR, jnp.float32),
        "pcm_tail": jnp.zeros((c, T.NUM_SAMPLES), jnp.float32),
    }


@partial(jax.jit, static_argnames=("frame_bytes", "js", "no_gain_control",
                                   "no_tonal", "bfu_idx_const"))
def encode_frames(pcm, frame_bytes=384, js=False, no_gain_control=True,
                  no_tonal=True, bfu_idx_const=0):
    planes, _ = encode_frames_chunk(pcm, None, None, frame_bytes, js,
                                    no_gain_control, no_tonal, bfu_idx_const)
    return planes


@partial(jax.jit, static_argnames=("frame_bytes", "js", "no_gain_control",
                                   "no_tonal", "bfu_idx_const"))
def encode_frames_bytes(pcm, frame_bytes=384, js=False, no_gain_control=True,
                        no_tonal=True, bfu_idx_const=0):
    """[C, T] PCM -> [F, frame_bytes] uint8 frames, fully ON DEVICE.

    Fuses the encoder with the device bitstream serializer
    (device_pack.pack_device) so only final frame bytes leave the chip —
    the batch-transcode fast path (byte-identical to
    frame.pack(encode_frames(...)))."""
    planes, _ = encode_frames_chunk(pcm, None, None, frame_bytes, js,
                                    no_gain_control, no_tonal, bfu_idx_const)
    return pack_device(planes, frame_bytes, js)


@partial(jax.jit, static_argnames=("frame_bytes", "js", "no_gain_control",
                                   "no_tonal", "bfu_idx_const"))
def encode_frames_chunk(pcm, state=None, next_pcm=None, frame_bytes=384,
                        js=False, no_gain_control=True, no_tonal=True,
                        bfu_idx_const=0):
    """Encode [C, T] PCM (T multiple of 1024) into ATRAC3 frame planes.

    `state` carries the exact cross-chunk recurrences (gain context, MDCT
    overlap, loudness IIR) for long tracks; `next_pcm` provides the
    lookahead input (the 1024 samples after this chunk, or None at track
    end).  Returns (planes, new_state).

    Gain control and tonal components are staged in follow-up commits; the
    current planes match the reference's --nogaincontrol --notonal mode.

    Returns dict of planes (per channel, per frame):
      num_bfu [C, F], coding_mode [C, F] (1 = CLC), wordlen [C, F, 32],
      sfi [C, F, 32], mant [C, F, 32, 128], gain_npoints [C, F, 4],
      gain_levels/gain_locs [C, F, 4, 8], loudness [F].
    """
    c, t = pcm.shape
    f = t // T.NUM_SAMPLES
    if state is None:
        state = init_state(c)

    # QMF needs ~366 input samples of history: prepend the previous chunk's
    # tail frame and drop its band outputs
    ext = jnp.concatenate([state["pcm_tail"], pcm], axis=-1)
    with jax.named_scope("filterbank"):
        bands = band_frames(ext)[:, 1:]              # [C, F, 4, 256]
    if next_pcm is None:
        next_head = jnp.zeros((c, 4, 128), pcm.dtype)
    else:
        # lookahead band samples: QMF of [this chunk's tail | next 1024];
        # the filter warmup needs ~366 prior input samples
        la = jnp.concatenate([pcm[:, -2048:], next_pcm], axis=-1)
        la_bands = filterbank.analysis(la * 0.25)[..., -256:-128]
        next_head = la_bands                          # [C, 4, 128]
    if js and c == 2:
        # M/S matrixing in the band-sample domain (atrac3denc.cpp:665-677;
        # M/S is linear, so matrixing the whole stream equals matrixing the
        # reference's per-frame buffers and gain-analysis windows)
        bands = jnp.stack([(bands[0] + bands[1]) * 0.5,
                           (bands[0] - bands[1]) * 0.5])
        next_head = jnp.stack([(next_head[0] + next_head[1]) * 0.5,
                               (next_head[0] - next_head[1]) * 0.5])

    if no_gain_control:
        # empty gain curves (SubbandInfo with 4 bands, 0 points each)
        gain_npoints = jnp.zeros((c, f, 4), jnp.int32)
        gain_levels = jnp.zeros((c, f, 4, 8), jnp.int32)
        gain_locs = jnp.zeros((c, f, 4, 8), jnp.int32)
        gain_scale_frame = jnp.ones((c, f, 4), jnp.float32)
        gain_ctx_out = state["gain"]
        es_carry = (state["mdct_prev"], state["next_overlap"])
        specs = mdct_frames(bands, prev_half=state["mdct_prev"])
        mdct_last = jnp.asarray(T.ENCODE_WINDOW) * bands[:, -1]
    else:
        with jax.named_scope("gain_mdct"):
            gain_levels, gain_locs, gain_npoints, gain_ctx_out = \
                gain.gain_control(bands, ctx=state["gain"],
                                  next_head=next_head)
            div = gain_divisors(gain_levels, gain_locs, gain_npoints)
            scale = first_level_scale(gain_levels, gain_npoints)
            gain_scale_frame, es_carry = gain.energy_scale(
                bands, div, scale, prev_half=state["mdct_prev"],
                prev_overlap_init=state["next_overlap"])
            specs = mdct_frames(bands, div, scale,
                                prev_half=state["mdct_prev"])
        mdct_last = es_carry[0]

    # loudness IIR (atrac3denc.cpp:811-841): stereo non-JS averages both
    # channels; mono and JS use channel 0 only.
    gs_per_line = jnp.repeat(gain_scale_frame, 256, axis=-1)    # [C, F, 1024]
    frame_loud = jnp.sum(specs * specs * gs_per_line * _LOUD_CURVE,
                         axis=-1)                               # [C, F]
    if c == 2 and not js:
        loud = psy.track_loudness_scan(
            frame_loud[0], frame_loud[1], jnp.ones((f,), bool),
            jnp.zeros((f,), bool), state["loudness"])
    else:
        loud = psy.track_loudness_scan(
            frame_loud[0], jnp.zeros((f,)), jnp.zeros((f,), bool),
            jnp.ones((f,), bool), state["loudness"])
    loudness = loud / T.LOUD_FACTOR                  # [F], shared by channels

    # tonal component extraction (atrac3denc.cpp:822-827); flatness and
    # loudness both use the pre-extraction spectrum
    if no_tonal:
        tonal_planes = None
        tonal_counts = None
        tonal_bits_fn = None
    else:
        with jax.named_scope("tonal"):
            flat = tonal.flatness_per_bfu(specs * specs)
            specs, tp = tonal.extract(specs, flat)
            tonal_planes = tonal.scale_groups(tp)
        # per-BFU block counts for the allocation discount (the count is
        # keyed on each block's first-component BFU)
        bfu_oh = jax.nn.one_hot(tonal_planes["bfu"], 32, dtype=jnp.int32)
        tonal_counts = jnp.sum(
            bfu_oh * tonal_planes["active"][..., None].astype(jnp.int32),
            axis=-2)
        tonal_bits_fn = tonal.make_cost_fn(tonal_planes)

    blocks = gather_bfu_blocks(specs)                # [C, F, 32, 128]
    with jax.named_scope("scale"):
        sfi, scaled, energy = scale_ops.scale_blocks(
            blocks, _GATHER_MASK, _SCALE_TABLE)
    # operator feedback (atrac_scale.cpp:150-167 prints per-value warnings;
    # the batched pipeline aggregates): |spec| > MAX_SCALE (1.0) is exactly
    # the condition under which the reference clamps and clips
    absb = jnp.abs(blocks)
    clip_count = jnp.sum(absb > 1.0, axis=(-1, -2)).astype(jnp.int32)
    clip_max = jnp.max(jnp.max(absb, -1), -1)
    spread = spread_from_sfi(sfi)

    # per-channel bit budget (WriteSoundUnit, atrac3_bitstream.cpp:830-892):
    # halfFrameSz*8 - 6 (numBlocks+codingMode) - header/gain-info bits;
    # the JS channel-1 header is the 14-bit WriteJsParams block
    half = frame_bytes // 2
    id_bits = jnp.asarray([14 if (js and ch == 1) else 6 for ch in range(c)]
                          )[:, None]
    header_bits = id_bits + 2 + jnp.sum(3 + gain_npoints * 9, axis=-1)

    if js:
        # M/S byte-budget shift from per-frame loudness (CalcMSBytesShift,
        # atrac3_bitstream.cpp:800-828); a mono input's empty side channel
        # gets the minimum budget (shift = maxAllowedShift)
        h1 = header_bits[1] if c == 2 else 14 + 2 + 3
        total_used = 12 + header_bits[0] + h1
        max_shift = half - (1 + (total_used - 1) // 8)
        if c == 2:
            total_loud = frame_loud[0] + frame_loud[1]
            ratio = jnp.where(total_loud > 0,
                              frame_loud[0] / total_loud - 0.5, 0.0)
            ms_shift = jnp.clip(
                jnp.round(frame_bytes * ratio).astype(jnp.int32),
                -max_shift, max_shift)
        else:
            ms_shift = jnp.broadcast_to(max_shift, (f,)).astype(jnp.int32)
    else:
        ms_shift = jnp.zeros((f,), jnp.int32)
    shift_per_ch = jnp.stack([ms_shift, -ms_shift])[:c]
    target = jnp.maximum(
        8 * (half + shift_per_ch) - 6 - header_bits, 1).astype(jnp.int32)

    with jax.named_scope("quant_memo"):
        qt = quant_tensors(scaled, _GATHER_MASK)
    with jax.named_scope("rate_control"):
        num_bfu, mode, wl = allocate(
            qt, sfi, gain_scale_frame, energy, spread,
            jnp.broadcast_to(loudness, (c, f)), target,
            tonal_counts=tonal_counts, tonal_bits_fn=tonal_bits_fn,
            bfu_idx_const=bfu_idx_const)

    # int8: |mantissa| <= 32, and the plane is the bulk of the host transfer;
    # recomputed at the chosen wordlen only (the full [.., 32, 8, 128] memo
    # never materializes — quant_tensors returns costs only)
    with jax.named_scope("final_mantissas"):
        mant = final_mantissas(scaled, _GATHER_MASK, wl)

    # compact dtypes: the planes cross the device->host link
    out = {
        "num_bfu": num_bfu.astype(jnp.int8),
        "coding_mode": mode,
        "wordlen": wl.astype(jnp.int8),
        "sfi": sfi.astype(jnp.int8),
        "mant": mant,
        "gain_npoints": gain_npoints.astype(jnp.int8),
        "gain_levels": gain_levels.astype(jnp.int8),
        "gain_locs": gain_locs.astype(jnp.int8),
        "loudness": loudness,
        "ms_shift": ms_shift,
        "clip_count": clip_count,
        "clip_max": clip_max,
    }
    if tonal_planes is not None:
        active, quant = tonal.block_quant(tonal_planes, wl, num_bfu)
        out["tonal_active"] = active
        out["tonal_start"] = tonal_planes["start"].astype(jnp.int16)
        out["tonal_len"] = tonal_planes["len"].astype(jnp.int8)
        out["tonal_sfi"] = tonal_planes["sfi"].astype(jnp.int8)
        out["tonal_quant"] = jnp.where(active, quant, 0).astype(jnp.int8)
        ohq = jax.nn.one_hot(quant, 8, dtype=jnp.int8)
        out["tonal_mant"] = jnp.sum(
            tonal_planes["mant"].astype(jnp.int8) * ohq[..., None],
            axis=-2).astype(jnp.int8)

    state_out = {"gain": gain_ctx_out, "mdct_prev": mdct_last,
                 "next_overlap": es_carry[1], "loudness": loud[-1],
                 "pcm_tail": pcm[:, -T.NUM_SAMPLES:]}
    return out, state_out


def encode_track(pcm: np.ndarray, frame_bytes=384, js=False,
                 no_gain_control=True, no_tonal=True, bfu_idx_const=0,
                 chunk_frames=1024, progress=None):
    """NumPy convenience wrapper: pads to a whole number of frames and
    encodes long tracks in exact chunks (bounded device memory; the carry
    state makes chunked output identical to whole-track output).

    progress: optional callback(percent:int) invoked after each chunk
    (reference progress display, main.cpp:67-74, 704)."""
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    c, t = pcm.shape
    pad = (-t) % T.NUM_SAMPLES
    if pad:
        pcm = np.pad(pcm, ((0, 0), (0, pad)))
    f_total = pcm.shape[1] // T.NUM_SAMPLES

    if f_total <= chunk_frames:
        planes = encode_frames(
            jnp.asarray(pcm), frame_bytes=frame_bytes, js=js,
            no_gain_control=no_gain_control, no_tonal=no_tonal,
            bfu_idx_const=bfu_idx_const)
        out = jax.device_get(planes)
        if progress is not None:
            progress(100)
        return out

    state = None
    outs = []
    for a in range(0, f_total, chunk_frames):
        b = min(a + chunk_frames, f_total)
        chunk = jnp.asarray(pcm[:, a * T.NUM_SAMPLES: b * T.NUM_SAMPLES])
        nxt = None
        if b < f_total:
            nxt = jnp.asarray(
                pcm[:, b * T.NUM_SAMPLES: (b + 1) * T.NUM_SAMPLES])
        planes, state = encode_frames_chunk(
            chunk, state, nxt, frame_bytes=frame_bytes, js=js,
            no_gain_control=no_gain_control, no_tonal=no_tonal,
            bfu_idx_const=bfu_idx_const)
        outs.append(jax.device_get(planes))
        if progress is not None:
            progress(int(b * 100 / f_total))
    merged = {}
    for k in outs[0]:
        axis = 0 if outs[0][k].ndim == 1 else 1
        merged[k] = np.concatenate([o[k] for o in outs], axis=axis)
    return merged
