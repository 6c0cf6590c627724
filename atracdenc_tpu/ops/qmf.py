"""Two-band QMF analysis/synthesis as whole-track strided convolutions.

The reference runs a 48-tap polyphase QMF one 512/256-sample block at a time
with a 46-sample persistent history (reference: src/qmf/qmf.h:47-89,
src/qmf/qmf.cpp:25-34).  Because the history is just the previous 46 input
samples, the streaming loop is exactly equivalent to one strided convolution
over the whole track with 46 leading zeros — which is how we express it here
so XLA can lower it to implicit GEMMs batched over channels/streams.

Definitions (matching the reference's streaming semantics bit-for-bit in
exact arithmetic, with zero initial history):

  analysis:  lower[m] = sum_{i<24} w[2i]   * x[2m + 1 - 2i]
             upper[m] = sum_{i<24} w[2i+1] * x[2m - 2i]
             out_sum  = lower + upper      (the "lower band" result)
             out_diff = lower - upper      (the "upper band" result)

  synthesis: merge[2m] = lo[m] + up[m]; merge[2m+1] = lo[m] - up[m]
             pcm[2p]   = sum_{i odd}  merge[2p + i - 46] * w[i]
             pcm[2p+1] = sum_{i even} merge[2p + i - 46] * w[i]

where w is the symmetric 48-tap prototype (w[i] = w[47-i] = 2*TapHalf[i]).
"""
import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["QMF_WINDOW", "qmf_analysis", "qmf_synthesis"]

# 24 half-taps of the 48-tap symmetric prototype lowpass
# (reference: src/qmf/qmf.cpp:25-32; the full window is TapHalf mirrored, x2).
_TAP_HALF = np.array([
    -0.00001461907, -0.00009205479, -0.000056157569, 0.00030117269,
    0.0002422519, -0.00085293897, -0.0005205574, 0.0020340169,
    0.00078333891, -0.0042153862, -0.00075614988, 0.0078402944,
    -0.000061169922, -0.01344162, 0.0024626821, 0.021736089,
    -0.007801671, -0.034090221, 0.01880949, 0.054326009,
    -0.043596379, -0.099384367, 0.13207909, 0.46424159,
], dtype=np.float64)

QMF_WINDOW = np.concatenate([_TAP_HALF, _TAP_HALF[::-1]]) * 2.0  # [48]
QMF_DELAY = 46  # analysis+synthesis group delay in input samples


_BLOCK_IN = 128     # input samples per output block (64 outputs at stride 2)
_WIN = 174          # window per block: 126 + 48-tap reach


def _blocked_fir(x: jax.Array, w, pad_lo: int) -> jax.Array:
    """Stride-2 FIR bank as a blocked-Toeplitz matmul.

    x [..., T] (T % 128 == 0); w [174, 128] static Toeplitz matrix with
    out[..., 64j + u] (col u) and its partner bank (col 64+u) both reading
    window_j = x_ext[128j : 128j+174], x_ext = pad(x, (pad_lo, 46-pad_lo)).

    A [B, 1, T] stride-2 conv_general_dilated has a single channel, which
    defeats implicit-GEMM tiling; this formulation keeps the same math as
    dense [*, 174] x [174, 128] matmuls.
    """
    t_in = x.shape[-1]
    t = -(-t_in // _BLOCK_IN) * _BLOCK_IN              # zero-extend to 128k
    j = t // _BLOCK_IN
    batch = x.shape[:-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(pad_lo, t - t_in + 46 - pad_lo)]
    x_ext = jnp.pad(x, pad)                            # [..., T+46]
    z1 = x_ext[..., :t].reshape(batch + (j, _BLOCK_IN))
    tail = x_ext[..., t:]                              # [..., 46]
    z2 = jnp.concatenate([z1[..., 1:, :46], tail[..., None, :]], axis=-2)
    win = jnp.concatenate([z1, z2], axis=-1)           # [..., j, 174]
    return jnp.einsum("...jk,kp->...jp", win, jnp.asarray(w, x.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def _analysis_kernels(dtype=np.float32):
    """47-tap even/odd polyphase kernels in cross-correlation layout.

    lower[m] = sum_j a[j] * x[2m+1-j]  with a[j] = w[j] for even j, else 0
    upper[m] = sum_j b[j] * x[2m+1-j]  with b[j] = w[j] for odd j, else 0
    Cross-correlation form: out[m] = sum_k x[2m+1-46+k] * h[k], h[k] = a/b[46-k].
    """
    a = np.zeros(47, dtype=np.float64)
    b = np.zeros(47, dtype=np.float64)
    a[0:47:2] = QMF_WINDOW[0:47:2]   # even taps -> lower
    b[1:47:2] = QMF_WINDOW[1:47:2]   # odd taps  -> upper
    return a[::-1].astype(dtype), b[::-1].astype(dtype)


def _analysis_matrix():
    """[174, 128] Toeplitz bank: col u = lower[64j+u], col 64+u = upper."""
    ka, kb = _analysis_kernels(np.float32)
    w = np.zeros((_WIN, _BLOCK_IN), np.float32)
    for u in range(64):
        for k in range(47):
            w[2 * u + k, u] = ka[k]
            w[2 * u + k, 64 + u] = kb[k]
    return w


_ANALYSIS_W = _analysis_matrix()


def qmf_analysis(x: jax.Array):
    """Split [..., T] (T % 128 == 0) into (sum, diff) half-rate bands
    [..., T/2].

    Equivalent to streaming TQmf::Analysis over consecutive blocks with zero
    initial history (reference: src/qmf/qmf.h:47-64).
    """
    # out[m] needs x at indices 2m+1-46 .. 2m+1  ->  pad_lo=45
    out = _blocked_fir(x, _ANALYSIS_W, pad_lo=45)      # [..., J, 128]
    j = out.shape[-2]
    half = x.shape[-1] // 2
    lower = out[..., :64].reshape(x.shape[:-1] + (j * 64,))[..., :half]
    upper = out[..., 64:].reshape(x.shape[:-1] + (j * 64,))[..., :half]
    return lower + upper, lower - upper


def qmf_synthesis(lo: jax.Array, up: jax.Array) -> jax.Array:
    """Merge half-rate (sum, diff) bands [..., M] back to [..., 2M].

    Equivalent to streaming TQmf::Synthesis with zero initial history
    (reference: src/qmf/qmf.h:66-89).  Output is delayed 46 samples relative
    to the analysis input (the standard QMF analysis+synthesis group delay).
    """
    m = lo.shape[-1]
    merge = jnp.stack([lo + up, lo - up], axis=-1).reshape(lo.shape[:-1] + (2 * m,))
    # pcm[2p]   = sum_{i odd}  merge[2p + i - 46] * w[i]
    # pcm[2p+1] = sum_{i even} merge[2p + i - 46] * w[i]
    # Cross-correlation with kernels k[j] = w_masked[j] evaluated at offset -46.
    out = _blocked_fir(merge, _SYNTHESIS_W, pad_lo=46)  # [..., J, 128]
    j = out.shape[-2]
    even = out[..., :64].reshape(lo.shape[:-1] + (j * 64,))[..., :m]
    odd = out[..., 64:].reshape(lo.shape[:-1] + (j * 64,))[..., :m]
    pcm = jnp.stack([even, odd], axis=-1).reshape(lo.shape[:-1] + (-1,))
    return pcm[..., : 2 * m]


def _synthesis_matrix():
    """[174, 128] Toeplitz bank: col u = pcm[2(64j+u)], col 64+u = odd."""
    k_even = np.zeros(48, np.float32)
    k_odd = np.zeros(48, np.float32)
    k_even[0:48:2] = QMF_WINDOW[0:48:2].astype(np.float32)
    k_odd[1:48:2] = QMF_WINDOW[1:48:2].astype(np.float32)
    w = np.zeros((_WIN, _BLOCK_IN), np.float32)
    for u in range(64):
        for k in range(48):
            w[2 * u + k, u] = k_odd[k]
            w[2 * u + k, 64 + u] = k_even[k]
    return w


_SYNTHESIS_W = _synthesis_matrix()
