"""ATRAC1 decoder: frame planes -> PCM, whole-track and batched.

Mirrors the reference decode path (src/atrac1denc.cpp:139-177): dequantize ->
windowed IMDCT with overlap-add -> QMF synthesis -> clip to [-1, 1].
Malformed frames are pre-substituted by the parser (frame.py) with silent
planes and a neutral (long) window mode, preserving overlap/QMF state exactly
like the reference (atrac1denc.cpp:151-162).
"""
import jax
import jax.numpy as jnp
import numpy as np

from . import tables as T
from . import filterbank
from .mdct import imdct_frames
from .encoder import _GATHER_LONG, _GATHER_SHORT, _GATHER_MASK, _BFU_TO_BAND


@jax.jit
def decode_frames(short_mask, wordlen, sfi, mant):
    """Planes -> PCM [C, F*512].

    short_mask [C, F, 3] bool; wordlen/sfi [C, F, 52]; mant [C, F, 52, 20].
    """
    c, f, _ = wordlen.shape

    # dequantize (atrac1_dequantiser.cpp:31-68)
    scale_tab = jnp.asarray(T.SCALE_TABLE)
    max_quant = 1.0 / (jnp.left_shift(1, jnp.maximum(wordlen, 2) - 1) - 1
                       ).astype(jnp.float32)
    vals = (scale_tab[sfi] * max_quant)[..., None] * mant.astype(jnp.float32)
    vals = jnp.where((wordlen >= 2)[..., None], vals, 0.0) * _GATHER_MASK

    # assemble [C, F, 512] spectra from the padded blocks; both line
    # layouts tile the spectrum with contiguous per-BFU runs, so the
    # scatter is two static concatenations + a per-BFU select instead of a
    # dynamic scatter
    import numpy as np
    short_per_bfu = sum(
        short_mask[..., band, None] * (np.asarray(T.BFU_TO_BAND) == band)
        for band in range(3)).astype(bool)            # [C, F, 52]
    vals_l = jnp.where(short_per_bfu[..., None], 0.0, vals)
    vals_s = jnp.where(short_per_bfu[..., None], vals, 0.0)

    def assemble_from(v, start_tab):
        order = np.argsort(np.asarray(start_tab)[:, 0], kind="stable")
        parts = [v[..., b, : int(T.SPECS_PER_BLOCK[b])] for b in order]
        return jnp.concatenate(parts, axis=-1)

    specs = assemble_from(vals_l, T.GATHER_LONG) \
        + assemble_from(vals_s, T.GATHER_SHORT)

    low = imdct_frames(specs[..., 0:128], short_mask[..., 0], 0).reshape(c, -1)
    mid = imdct_frames(specs[..., 128:256], short_mask[..., 1], 1).reshape(c, -1)
    hi = imdct_frames(specs[..., 256:512], short_mask[..., 2], 2).reshape(c, -1)

    pcm = filterbank.synthesis(low, mid, hi)
    return jnp.clip(pcm, -1.0, 1.0)


def decode_track(planes, exact: bool = True) -> np.ndarray:
    """Planes -> PCM.  exact=True (default, and what the CLI uses) runs the
    float32 bit-exact reference-semantics path (exact_synth.py, validated
    float-for-float against the reference decoder); exact=False runs this
    module's batched JAX formulation of the same math (within ~1e-6)."""
    if exact:
        from .exact_synth import decode_track_exact
        return decode_track_exact(planes)
    return np.asarray(decode_frames(
        jnp.asarray(planes["short_mask"]), jnp.asarray(planes["wordlen"]),
        jnp.asarray(planes["sfi"]), jnp.asarray(planes["mant"])))
