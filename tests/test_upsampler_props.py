"""Spectral-upsampler + flatness property tests (fast tier).

Mirrors the reference's transient_spectral_upsampler_ut.cpp property suite
(DC removal, high-frequency RMS preservation, chirp-no-false-transient) and
the atrac_psy_common_ut.cpp flatness properties, adapted to the batched
formulation: `gain.upsample` / `gain.upsample_region` operate on the AT3
subband domain (Fs = 11025, low cut 800 Hz) and the transient check runs
through the full `gain.gain_control` staircase builder.
"""
import numpy as np
import jax.numpy as jnp

from atracdenc_tpu.models.atrac3 import gain, tonal

FS = 11025.0


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def _sine(freq_hz, n=512, amp=1.0):
    t = np.arange(n) / FS
    return (amp * np.sin(2 * np.pi * freq_hz * t)).astype(np.float32)


def test_dc_removed_by_low_cut():
    sig, hfr = gain.upsample(jnp.ones((512,), jnp.float32))
    assert _rms(sig[1024:3072]) < 0.01
    assert float(hfr) < 1e-3


def test_high_freq_sine_preserves_rms():
    """[1024, 3072) of the 8x output is the ideal interpolation of the
    Planck-windowed input region [128, 384): per-sample RMS must match
    within 5% for band-limited sinusoids above the cutoff
    (transient_spectral_upsampler_ut.cpp:129-151)."""
    win = gain._planck_window()
    for freq in (1378.0, 2756.0, 4134.0, 2000.0, 3000.0):
        x = _sine(freq)
        sig, hfr = gain.upsample(jnp.asarray(x))
        ref_rms = _rms((x * win)[128:384])
        out_rms = _rms(sig[1024:3072])
        assert ref_rms > 0
        assert abs(out_rms - ref_rms) < 0.05 * ref_rms, freq
        assert float(hfr) > 0.9, freq


def test_sub_cutoff_sine_suppressed():
    sig, hfr = gain.upsample(jnp.asarray(_sine(300.0)))
    assert float(hfr) < gain.HIGH_FREQ_THRESHOLD
    assert _rms(sig[1024:3072]) < 0.1


def test_region_matmul_matches_fft_path():
    """upsample_region (the matmul formulation the encoder uses) must agree
    with the FFT formulation on both outputs."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 512)).astype(np.float32))
    sig, hfr = gain.upsample(x)
    region, hfr_m = gain.upsample_region(x)
    np.testing.assert_allclose(np.asarray(region),
                               np.asarray(sig[..., 1024:3072]),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(hfr_m), np.asarray(hfr),
                               rtol=1e-3)


def test_chirp_produces_no_false_transient():
    """A constant-amplitude linear sweep 0 -> Fs/2 must produce zero gain
    points in every band (the reference pins the same invariant frame by
    frame, transient_spectral_upsampler_ut.cpp:196-280)."""
    frames = 40
    n = 256 * frames
    t = np.arange(n) / FS
    rate = (FS / 2) / (n / FS)                    # ~5.9 kHz/s sweep
    chirp = (0.5 * np.sin(2 * np.pi * 0.5 * rate * t * t)).astype(np.float32)
    bands = np.zeros((1, frames, 4, 256), np.float32)
    bands[0, :, 0] = chirp.reshape(frames, 256)
    _, _, npoints, _ = gain.gain_control(jnp.asarray(bands))
    # the final frame's lookahead is silence (track end) — a genuine
    # release transient; the reference test loop likewise stops at the
    # last frame with real lookahead
    assert int(np.asarray(npoints)[:, :-1].sum()) == 0


def test_flatness_properties():
    """CalcSpectralFlatnessPerBfu invariants (atrac_psy_common_ut.cpp):
    silence -> 1, flat energy -> ~1, a single spike -> near 0."""
    e = np.zeros((3, 1024), np.float32)
    e[1] = 0.25                                   # flat
    e[2, 100] = 4.0                               # lone spike in one BFU
    flat = np.asarray(tonal.flatness_per_bfu(jnp.asarray(e)))
    assert np.all(flat[0] == 1.0)
    assert np.all(flat[1] > 0.99)
    spike_bfu = int(np.searchsorted(
        np.cumsum(np.asarray(tonal.T.SPECS_PER_BLOCK)), 100, "right"))
    assert flat[2, spike_bfu] < 0.05
