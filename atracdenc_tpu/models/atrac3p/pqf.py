"""ATRAC3+ 16-band PQF analysis as one strided convolution.

The reference computes, per output sample, a 12-tap x 32-phase FIR
("vectoring") followed by a butterfly + DCT-IV-16 ("matrixing")
(reference: src/atrac/atrac3plus_pqf/atrac3plus_pqf.c:81-106).  Folding the
butterfly/DCT into the FIR gives one [16, 384] kernel applied with stride 16
over the input stream — a single matmul-shaped conv batched over channels and
the whole track, with the 368-sample overlap expressed as left padding.

The inverse (IPQF, ffmpeg semantics — the reference validates its analysis
against it, ipqf_ut.cpp) is provided for the QA decoder: also reformulated
as a whole-track convolution of the per-sample DCT outputs.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from atracdenc_tpu.ops.mdct import _mdct_matrix_np
from . import tables as T

OVERLAP = 368          # PROTO_SZ - SUBBANDS_NUM
# whole-track analysis+synthesis round-trip delay, measured exactly (the
# reference UT uses 368+23 because of its streaming frame alignment,
# ipqf_ut.cpp:112-308; the whole-track convolution form has no +23)
PQF_DELAY_SAMPLES = 368


@lru_cache(maxsize=None)
def _dct4_16_matrix() -> np.ndarray:
    """[16, 16] M with out = M @ yy matching atde_do_dct4_16 with the PQF's
    scale (mdct.cpp:56-81: TMIDCT<32>(32 * 128*512), out[i] = -x[i+8])."""
    # TMIDCT<32>(scale) == (scale/32) * direct_imdct ; direct_imdct[n] =
    # sum_k X[k] cos(2pi/32 (n+0.5+8)(k+0.5)) (see ops/mdct.py conventions)
    m = _mdct_matrix_np(32)                   # [16, 32] MDCT basis
    imdct = m.T                               # [32, 16]: inv[n] = sum_k X[k]...
    factor = (32.0 * 128.0 * 512.0) / 32.0
    return -factor * imdct[8:24, :]           # out[i] = -inv[i+8]


@lru_cache(maxsize=None)
def _analysis_kernel() -> np.ndarray:
    """[16, 384] combined kernel: out[sb] = sum_p K[sb, p] * x[p]."""
    fir = np.asarray(T.PQF_FIR, np.float64)
    dct = _dct4_16_matrix()                   # [16, 16] on yy
    # y[k] = sum_j fir[k*12+j] * x[j*32 + k]       (vectoring, k < 32)
    # yy[i] = y[i+8] + y[7-i]; yy[i+8] = y[i+16] + y[31-i]  (butterfly)
    # res = dct @ yy ; out[sb] = res[15 - sb]
    b = np.zeros((16, 32))
    for i in range(8):
        b[i, i + 8] = 1.0
        b[i, 7 - i] = 1.0
        b[i + 8, i + 16] = 1.0
        b[i + 8, 31 - i] = 1.0
    m = (dct @ b)[::-1]                       # [16(sb), 32(k)]
    k = np.zeros((16, 384))
    for kk in range(32):
        for j in range(12):
            k[:, j * 32 + kk] += m[:, kk] * fir[kk * 12 + j]
    return np.asarray(k, np.float32)


def analysis(pcm, with_history=False):
    """[..., T] PCM (T multiple of 2048) -> [..., 16, T/16] band samples.

    Equivalent to streaming at3plus_pqf_do_analyse with zero initial overlap:
    output sample i of band sb uses input [i*16 - 368, i*16 + 16).

    with_history=True: the input already carries its own OVERLAP samples of
    real filter history as a prefix (chunked encoding); no zero padding is
    added and the output covers the T-OVERLAP post-prefix samples."""
    kern = jnp.asarray(_analysis_kernel(), pcm.dtype)  # [16, 384]
    batch = pcm.shape[:-1]
    t = pcm.shape[-1] - (OVERLAP if with_history else 0)
    lhs = pcm.reshape((-1, 1, pcm.shape[-1]))
    rhs = kern[:, None, :]                    # [O=16, I=1, K=384]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(16,),
        padding=[(0 if with_history else OVERLAP, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST)
    return out.reshape(batch + (16, t // 16))


def ipqf_np(bands: np.ndarray) -> np.ndarray:
    """QA inverse PQF (ffmpeg ff_atrac3p_ipqf semantics, NumPy reference).

    bands: [16, M] band samples -> [16*M] PCM.  Matches the decoder IPQF the
    reference validates against (ut/atrac3plusdsp.c:57-96).
    """
    nsb, m = bands.shape
    # per-sample DCT4: idct_out[15-k] = sum_n in[n] cos(pi/16 (n+.5)(k+.5))/1024
    n_i = np.arange(16)
    dct = np.cos(np.pi / 16.0 * np.outer(n_i + 0.5, n_i + 0.5)) / 1024.0
    idct = (bands.T @ dct)[:, ::-1]           # [M, 16] idct_out per sample

    # 24-slot ring: the reference's mod23_lut maps x -> (x-1) mod 24
    # (ut/atrac3plusdsp.c:41-45 with buf1[24][8])
    buf1 = np.zeros((24, 8), np.float32)
    buf2 = np.zeros((24, 8), np.float32)
    pos = 0
    out = np.zeros(16 * m, np.float32)
    c1 = np.asarray(T.IPQF_COEFFS1, np.float64)
    c2 = np.asarray(T.IPQF_COEFFS2, np.float64)
    for s in range(m):
        buf1[pos] = idct[s, 8:16]
        buf2[pos] = idct[s, 7::-1]
        pos_now = pos
        pos_next = (pos_now + 1) % 24
        acc = np.zeros(16)
        for t_ in range(12):
            acc[:8] += buf1[pos_now] * c1[t_, :8] + buf2[pos_next] * c2[t_, :8]
            acc[8:] += buf1[pos_now][::-1] * c1[t_, 8:] \
                + buf2[pos_next][::-1] * c2[t_, 8:]
            pos_now = (pos_now + 2) % 24
            pos_next = (pos_next + 2) % 24
        out[s * 16: s * 16 + 16] = acc
        pos = (pos - 1) % 24
    return out
