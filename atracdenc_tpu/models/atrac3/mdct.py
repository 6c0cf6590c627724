"""ATRAC3 windowed MDCT/IMDCT with gain modulation, batched over frames.

Reference semantics (src/atrac3denc.cpp:33-91 + gain_processor.h): per band,
the MDCT input is [stored prev half | windowed current], where the stored
half is the previous frame's current half, windowed by the rising
EncodeWindow and divided by the previous frame's gain-divisor curve; at MDCT
time it is additionally divided by the current frame's first gain level.
Because the stored half is a pure function of the *previous* frame's samples
and curve, the whole track batches with one frame shift — no recurrence.

Gain divisor curves are built from the quantized (level, location) points via
a precomputed float32 ramp table so the sequential `level *= gainInc` of the
reference is reproduced exactly (gain_processor.h:95-120).
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from atracdenc_tpu.ops.mdct import mdct_matrix
from . import tables as T

_ENC_WIN = _npc(np.asarray(T.ENCODE_WINDOW))
_DEC_WIN = _npc(np.asarray(T.DECODE_WINDOW))
_GAIN_LEVEL = _npc(np.asarray(T.GAIN_LEVEL))


@lru_cache(maxsize=None)
def _ramp_table_np() -> np.ndarray:
    """[16, 16, 8] float32: sequential level * inc^k products for a ramp from
    level index `cur` toward `next` (gain_processor.h:108-118)."""
    out = np.empty((16, 16, T.LOC_SZ), np.float32)
    for cur in range(16):
        for nxt in range(16):
            inc = T.GAIN_INTERPOLATION[nxt - cur + T.GAIN_INTERPOLATION_POS_SHIFT]
            level = T.GAIN_LEVEL[cur]
            for k in range(T.LOC_SZ):
                out[cur, nxt, k] = level
                level = np.float32(level * inc)
    return out


def gain_divisors(levels, locs, npoints):
    """Per-sample divisor curves from gain points.

    levels, locs: [..., P] int32 (P <= 8, padded arbitrarily beyond npoints)
    npoints: [...] int32
    Returns div [..., 256] float32 (all-ones when npoints == 0).

    Gain points are 8-sample-aligned (loc is in LOC_SZ units) and locs
    strictly ascend, so each 8-sample block is either one point's ramp or a
    constant level — everything resolves with one-hot selections (exact:
    each one-hot row has a single 1), no gathers.
    """
    ramp_flat = jnp.asarray(_ramp_table_np().reshape(256, T.LOC_SZ))
    p = levels.shape[-1]
    batch = levels.shape[:-1]
    # flatten lanes to rank <= 3 throughout (high-rank small-minor-dim
    # layouts lowered badly)
    levels = levels.reshape(-1, p)
    locs = locs.reshape(-1, p)
    np_f = npoints.reshape(-1)
    slot = jnp.arange(p)
    valid = slot < np_f[:, None]
    locb = jnp.where(valid, locs, 64)           # block units; invalid: out
    lev = jnp.where(valid, levels, T.EXPONENT_OFFSET)
    lev_ext = jnp.concatenate(
        [lev, jnp.full((lev.shape[0], 1), 4, lev.dtype)], axis=-1)

    b = jnp.arange(256 // T.LOC_SZ)
    # points at or before block b (const region selector)
    idx_b = jnp.sum((locb[:, None, :] <= b[None, :, None]), axis=-1)
    sel = jnp.minimum(idx_b, np_f[:, None])                 # [L, 32]
    oh_sel = sel[..., None] == jnp.arange(p + 1)
    lev_at = jnp.sum(jnp.where(oh_sel, lev_ext[:, None, :], 0), axis=-1)
    oh_lvl = lev_at[..., None] == jnp.arange(16)
    const_div = jnp.sum(jnp.where(oh_lvl, _GAIN_LEVEL, 0.0), axis=-1)

    # point p's own block ramps from lev[p] toward lev_ext[p+1]; the
    # one-hot row selects exactly one table row, and Precision.HIGHEST
    # keeps the f32 ramp values exact (a default-precision pass, bf16 or
    # TF32, would truncate their mantissas)
    cn = jnp.where(valid, lev * 16 + lev_ext[:, 1:], 255)
    oh_cn = (cn.reshape(-1)[:, None] == jnp.arange(256)) \
        .astype(jnp.float32)
    rampvals = jnp.dot(oh_cn, ramp_flat,
                       precision=jax.lax.Precision.HIGHEST) \
        .reshape(cn.shape + (T.LOC_SZ,))                    # [L, P, 8]
    oh_b = (locb[:, None, :] == b[None, :, None])           # [L, 32, P]
    has_ramp = oh_b.any(-1)
    ramp_b = jnp.sum(jnp.where(oh_b[..., None], rampvals[:, None, :, :],
                               0.0), axis=-2)               # [L, 32, 8]
    div_b = jnp.where(has_ramp[..., None], ramp_b, const_div[..., None])
    div = div_b.reshape(div_b.shape[0], 256)
    div = jnp.where((np_f > 0)[:, None], div, 1.0)
    return div.reshape(batch + (256,))


def first_level_scale(levels, npoints):
    """GainLevel[first point] or 1.0 when no points (gain_processor.h:97)."""
    lev0 = jnp.where(npoints > 0, levels[..., 0], T.EXPONENT_OFFSET)
    return jnp.asarray(_GAIN_LEVEL)[lev0]


def mdct_frames(bands, div=None, scale=None, prev_half=None):
    """Forward windowed MDCT over a whole track (or one exact chunk).

    bands: [..., F, 4, 256] per-frame band samples (QMF output, /4 scaled)
    div:   [..., F, 4, 256] gain divisor curves (optional)
    scale: [..., F, 4] first-level scale of the *current* frame's curve
           (divides the stored previous half — gain_processor.h:97-105)
    prev_half: [..., 4, 256] carried windowed-modulated half from the frame
           before this chunk (zeros at track start)
    Returns specs [..., F, 1024] (odd bands spectrum-reversed, reference
    atrac3denc.cpp:52-54).
    """
    cur = bands if div is None else bands / div
    stored = _ENC_WIN * cur                      # windowed modulated current
    if prev_half is None:
        prev = jnp.pad(stored[..., :-1, :, :], [(0, 0)] * (bands.ndim - 3)
                       + [(1, 0), (0, 0), (0, 0)])
    else:
        prev = jnp.concatenate(
            [prev_half[..., None, :, :], stored[..., :-1, :, :]], axis=-3)
    if scale is not None:
        prev = prev / scale[..., None]
    tail = _ENC_WIN[::-1] * cur
    buf = jnp.concatenate([prev, tail], axis=-1)  # [..., F, 4, 512]

    basis = mdct_matrix(512, 1.0 / 512.0, buf.dtype)  # TMDCT<512>(1)
    spec = jax.lax.dot_general(
        buf, basis, dimension_numbers=(((buf.ndim - 1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST, preferred_element_type=buf.dtype)
    swap = jnp.stack([spec[..., 0, :], spec[..., 1, ::-1],
                      spec[..., 2, :], spec[..., 3, ::-1]], axis=-2)
    return swap.reshape(bands.shape[:-2] + (1024,))


def imdct_frames(specs, div=None, scale=None):
    """Inverse MDCT with overlap-add and gain demodulation (QA decoder).

    specs: [..., F, 1024]
    div:   [..., F, 4, 256] divisor curve of each frame's own gain points
    scale: [..., F, 4] first-level scale of each frame's own curve
    Returns bands [..., F, 4, 256]; out[f] reconstructs the band samples of
    input frame f-1 (the inherent one-frame OLA latency).

    Reference Demodulate (gain_processor.h:66-93):
      out[p] = (head_f[p] * scale_f + tail_{f-1}[p]) * div_{f-1}[p]
    — the head of frame f is scaled by frame f's first gain level, and the
    reassembled segment is re-multiplied by frame f-1's divisor curve.
    """
    s = specs.reshape(specs.shape[:-1] + (4, 256))
    s = jnp.stack([s[..., 0, :], s[..., 1, ::-1], s[..., 2, :],
                   s[..., 3, ::-1]], axis=-2)
    basis = mdct_matrix(512, 1.0, s.dtype)       # TMIDCT<512>(512) == direct
    inv = jax.lax.dot_general(
        s, basis, dimension_numbers=(((s.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST, preferred_element_type=s.dtype)
    win = jnp.concatenate([2.0 * _DEC_WIN, (2.0 * _DEC_WIN)[::-1]])
    inv = inv * win                               # [..., F, 4, 512]
    head, tail = inv[..., :256], inv[..., 256:]
    prev = jnp.pad(tail[..., :-1, :, :], [(0, 0)] * (inv.ndim - 3)
                   + [(1, 0), (0, 0), (0, 0)])
    cur = head if scale is None else head * scale[..., None]
    out = cur + prev
    if div is not None:
        div_prev = jnp.pad(div[..., :-1, :, :], [(0, 0)] * (div.ndim - 3)
                           + [(1, 0), (0, 0), (0, 0)], constant_values=1.0)
        out = out * div_prev
    return out
