"""The AT3 quant memo (bitalloc.quant_tensors) against the reference-float
oracle of exact_enc: per (BFU, wordlen), the CLC and VLC spectrum bits of
the (energy-adjusted) mantissas and the energy ratio e1/e2
(QuantMantisas + CalcSpecsBitsConsumption, atrac_scale.cpp:40-130,
atrac3_bitstream.cpp:163-220)."""
import jax
import jax.numpy as jnp
import numpy as np

from atracdenc_tpu.models.atrac3 import bitalloc, exact_enc, tables as T
from atracdenc_tpu.models.atrac3.encoder import _GATHER_MASK

_FMAX = np.finfo(np.float32).max


def _inputs(seed=0, n=4):
    rng = np.random.default_rng(seed)
    scaled = (0.999 * np.tanh(rng.standard_normal((n, 32, 128)))
              ).astype(np.float32)
    # zero out invalid lanes like the real pipeline does
    return scaled * np.asarray(_GATHER_MASK)


def _oracle(block_vals, wl, bfu):
    """(err, clc, vlc) of one BFU at one wordlen, reference arithmetic;
    err sanitized like quant_tensors (NaN -> 0, inf -> FLT_MAX)."""
    mant, err = exact_enc.quant_mantissas_exact(
        block_vals, exact_enc._MAXQ[wl], bfu > T.LOSY_NAQ_START)
    err = 0.0 if np.isnan(err) else (_FMAX if np.isinf(err) else err)
    return (np.float32(err), exact_enc._clc_bits(wl, len(block_vals)),
            exact_enc._vlc_bits(wl, mant))


def _check(scaled, qt, bfus=range(32)):
    err, clc, vlc = (np.asarray(qt[k]) for k in ("err", "clc", "vlc"))
    for i in range(scaled.shape[0]):
        for b in bfus:
            vals = scaled[i, b, :int(T.SPECS_PER_BLOCK[b])]
            for wl in range(1, 8):
                e, c, v = _oracle(vals, wl, b)
                assert clc[i, b, wl] == c, (i, b, wl)
                assert vlc[i, b, wl] == v, (i, b, wl)
                # sequential f32 sums (oracle) vs vectorized sums: ulps
                np.testing.assert_allclose(err[i, b, wl], e, rtol=1e-5,
                                           err_msg=str((i, b, wl)))


def test_plain_costs_match():
    """BFUs below the EA region: plain rounding."""
    scaled = _inputs()
    qt = jax.jit(lambda s: bitalloc.quant_tensors(s, _GATHER_MASK))(scaled)
    _check(scaled, qt, bfus=range(T.LOSY_NAQ_START + 1))


def test_quant_tensors_equivalent():
    """Every BFU, including the energy-adjusted region and its wl==1 pair
    codebook."""
    scaled = _inputs(seed=1, n=3)
    qt = bitalloc.quant_tensors(jnp.asarray(scaled), _GATHER_MASK)
    _check(scaled, qt)


def test_quant_tensors_edge_inputs():
    """Silent blocks (0/0 -> NaN -> 0), all-tiny blocks (e2 == 0 at
    mul > 0 -> inf -> FLT_MAX), and values pinned to the rounding and the
    |delta| < 0.25 EA-candidate boundaries."""
    rng = np.random.default_rng(3)
    x = np.zeros((5, 32, 128), np.float32)
    # row 0: silence; row 1: tiny values that quantize to all-zero
    x[1] = 1e-6
    # row 2: exact half-integer multiples of 1/maxq (rounding boundary)
    x[2] = (np.round(rng.uniform(-15, 15, (32, 128))) + 0.5) / 15.5
    # row 3: candidates straddling the 0.25 delta boundary at wl 2 (2.5)
    x[3] = (np.round(rng.uniform(-2, 2, (32, 128)))
            + rng.choice([0.249, 0.25, 0.251, 0.75], (32, 128))) / 2.5
    # row 4: dense random
    x[4] = 0.999 * np.tanh(rng.standard_normal((32, 128)))
    scaled = (np.clip(x, -0.9999, 0.9999)
              * np.asarray(_GATHER_MASK)).astype(np.float32)
    qt = bitalloc.quant_tensors(jnp.asarray(scaled), _GATHER_MASK)
    assert np.isfinite(np.asarray(qt["err"])).all()
    _check(scaled, qt)


def test_quant_tensors_full_under_vmap():
    """The batch transcoder vmaps the encoder over streams: the vmapped
    memo equals the unbatched one exactly, and the oracle on a slice."""
    scaled = _inputs(seed=2, n=6).reshape(2, 3, 32, 128)
    qt_b = bitalloc.quant_tensors(jnp.asarray(scaled), _GATHER_MASK)
    qt_v = jax.vmap(lambda s: bitalloc.quant_tensors(
        s, _GATHER_MASK))(jnp.asarray(scaled))
    for k in ("err", "clc", "vlc"):
        assert np.array_equal(np.asarray(qt_b[k]), np.asarray(qt_v[k])), k
    _check(scaled[1], {k: v[1] for k, v in qt_v.items()})
