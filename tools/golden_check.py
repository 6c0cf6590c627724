"""Byte-identity report against the reference-oracle golden frames.

Runs every golden vector through the current encoders on the current
backend and reports per-case byte identity against the floor the CPU test
suites assert for the same vector.  This is the perf-work guard (run
after each optimization), the golden phase of chip_smoke.py and the body
of the chip-marked golden tests.

Usage:  python tools/golden_check.py [--json out.json] [--diff]
"""
import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
GOLDEN = os.path.join(REPO, "tests", "golden")

CASES = [
    # (name, npz, pcm key, ref key, encode kwargs, floor); each floor is
    # the one the CPU suite asserts for that vector
    ("plain", "at3_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=384), 0.99),                       # test_at3_codec
    ("default", "at3_default_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=384, no_gain_control=False, no_tonal=False),
     0.98),                                              # test_at3_gain
    ("default_stress", "at3_default_golden.npz", "pcm_stress", "ref_stress",
     dict(frame_bytes=384, no_gain_control=False, no_tonal=False),
     0.85),                                              # test_at3_gain
    ("tonal", "at3_tonal_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=384, no_tonal=False), 0.99),       # test_at3_tonal
    ("tonal_dense", "at3_tonal_dense_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=384, no_tonal=False), 0.97),       # test_at3_tonal
    ("js", "at3_js_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=192, js=True, no_gain_control=False, no_tonal=False),
     0.99),                                              # test_at3_js
    ("js_mono", "at3_js_golden.npz", "pcm_mono", "ref_mono",
     dict(frame_bytes=192, js=True, no_gain_control=False, no_tonal=False),
     0.85),                                              # test_at3_js
]

AT1_CASES = [("at1_golden.npz", "at1_ref.aea"),
             ("at1_stress_pcm.npz", "at1_stress_ref.aea")]
AT1_DECODE_BOUND = 2e-4          # test_at1_golden: JAX decoder vs reference
AT3P_CASES = [("pcm_mixed", "ref_mixed"), ("pcm_loud", "ref_loud")]


def at3_case(name, npz, pk, rk, kw, floor):
    """{identity, frames, floor, ok} for one AT3 golden vector."""
    from atracdenc_tpu.models.atrac3.encoder import encode_track
    from atracdenc_tpu.models.atrac3 import frame as at3_frame

    d = np.load(os.path.join(GOLDEN, npz))
    pcm, ref = d[pk], d[rk]
    ours = at3_frame.pack(encode_track(pcm, **kw), kw["frame_bytes"],
                          js=kw.get("js", False))
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    eq = ours == ref
    ident = float(eq.mean())
    return {"identity": ident, "floor": floor, "ok": ident > floor,
            "frames": f"{int(eq.all(axis=1).sum())}/{ref.shape[0]}",
            "eq": eq, "ours": ours, "ref": ref}


def _psnr(x, y):
    e = x - y
    return 10 * np.log10(np.mean(x ** 2) / max(np.mean(e ** 2), 1e-20))


def _split_channels(planes, channels):
    return {k: v.reshape((v.shape[0] // channels, channels) + v.shape[1:])
            .swapaxes(0, 1) for k, v in planes.items() if k != "valid"}


def at1_case(npz, ref_aea):
    """AT1 fast path on one golden vector: byte identity with the
    reference stream (reported), and the CPU suite's floor — decoded
    quality no worse than the reference's by 0.1 dB
    (test_at1_golden.test_encoder_quality_parity_on_golden_input)."""
    from atracdenc_tpu.containers import aea
    from atracdenc_tpu.models.atrac1 import frame as at1_frame
    from atracdenc_tpu.models.atrac1.decoder import decode_track
    from atracdenc_tpu.models.atrac1.encoder import encode_track

    pcm = np.load(os.path.join(GOLDEN, npz))["pcm_in"]
    ref_frames, ch, _, _ = aea.read(os.path.join(GOLDEN, ref_aea))
    planes = encode_track(pcm)
    merged = {k: np.swapaxes(np.asarray(v), 0, 1).reshape(
        (-1,) + v.shape[2:]) for k, v in planes.items()}
    ours = at1_frame.pack(merged)
    ours[0] = 0                       # the AEA writer's dummy first frame
    n = min(len(ours), len(ref_frames))
    ident = float((ours[:n] == ref_frames[:n]).mean())

    ref_rec = decode_track(_split_channels(at1_frame.unpack(ref_frames), ch))
    ours_rec = decode_track(planes)
    m = min(ref_rec.shape[1], ours_rec.shape[1], pcm.shape[1]) - 1024
    x = pcm[:, 512:m].astype(np.float64)
    p_ref = _psnr(x, ref_rec[:, 512:m].astype(np.float64))
    p_ours = _psnr(x, ours_rec[:, 512:m].astype(np.float64))
    return {"identity": ident, "psnr_db": p_ours, "ref_psnr_db": p_ref,
            "ok": bool(p_ours > p_ref - 0.1)}


def at1_decode_case():
    """The batched JAX AT1 decoder on the reference stream against the
    reference decoder's PCM (test_at1_golden bound)."""
    from atracdenc_tpu.containers import aea
    from atracdenc_tpu.models.atrac1 import frame as at1_frame
    from atracdenc_tpu.models.atrac1.decoder import decode_track

    ref_dec = np.load(os.path.join(GOLDEN, "at1_golden.npz"))["ref_decoded"]
    frames, ch, _, _ = aea.read(os.path.join(GOLDEN, "at1_ref.aea"))
    ours = decode_track(_split_channels(at1_frame.unpack(frames), ch),
                        exact=False)
    n = min(ours.shape[1], ref_dec.shape[1])
    err = float(np.abs(ours[:, :n] - ref_dec[:, :n]).max())
    return {"max_abs_err": err, "bound": AT1_DECODE_BOUND,
            "ok": err < AT1_DECODE_BOUND}


def at3p_case(pk, rk):
    """AT3P GHA-off flow against the reference writer: the CPU suite
    asserts every byte (test_at3p_codec)."""
    from atracdenc_tpu.models.atrac3p import frame as at3p_frame
    from atracdenc_tpu.models.atrac3p.encoder import encode_track

    data = np.load(os.path.join(GOLDEN, "at3p_golden.npz"))
    ours = at3p_frame.pack(encode_track(data[pk], use_gha=False), 2)
    ref = data[rk]
    n = min(len(ours), len(ref))
    ident = float((ours[:n] == ref[:n]).mean())
    return {"identity": ident, "floor": 1.0, "ok": ident == 1.0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--diff", action="store_true",
                    help="print first diverging byte per non-identical frame")
    args = ap.parse_args()

    report = {}
    for case in CASES:
        name = case[0]
        r = at3_case(*case)
        report[name] = {"byte_identity": round(r["identity"], 6),
                        "frames_identical": r["frames"]}
        print(f"{name:16s} bytes {r['identity'] * 100:8.4f}%   frames "
              f"{r['frames']}   floor {case[-1] * 100:.0f}%")
        if args.diff:
            eq, ours, ref = r["eq"], r["ours"], r["ref"]
            for f in np.nonzero(~eq.all(axis=1))[0]:
                b = int(np.nonzero(ours[f] != ref[f])[0][0])
                print(f"  frame {f}: first diff at byte {b} "
                      f"(ours {ours[f, b]:02x} ref {ref[f, b]:02x})")
    if args.json:
        json.dump(report, open(args.json, "w"), indent=1)


if __name__ == "__main__":
    main()
