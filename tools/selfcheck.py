"""Fast byte-identity regression guard for perf work.

Encodes a small deterministic corpus in every key mode and compares SHA256
of the output bytes against tests/golden/selfcheck_hashes.json (written
with --update).  The round-1 suite validated these bytes against the
reference oracle; any optimization that changes a hash has changed the
bitstream and must re-run the full golden suite.

Hashes are backend-specific (float knife edges differ between the GPU and
the CPU backend); the json records the platform it was taken on.

Usage:  python tools/selfcheck.py [--update] [--platform-key KEY]
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
HASH_FILE = os.path.join(REPO, "tests", "golden", "selfcheck_hashes.json")


def corpus(streams=4, channels=2, seconds=1.5):
    t = int(44100 * seconds)
    t -= t % 2048
    rng = np.random.default_rng(7)
    n = np.arange(t, dtype=np.float64)
    base = (0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
            + 0.1 * np.sin(2 * np.pi * 3001.0 * n / 44100.0))
    # an attack transient so gain control has real work
    base[t // 2: t // 2 + 2000] += 0.4 * np.sin(
        2 * np.pi * 7000.0 * n[:2000] / 44100.0)
    pcm = np.clip(base[None, None, :] * np.asarray([1.0, 0.8])[None, :, None]
                  + 0.05 * rng.standard_normal((streams, channels, t)),
                  -1, 1).astype(np.float32)
    return pcm


def compute_hashes():
    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac3.encoder import encode_frames_bytes

    pcm = corpus()
    x3 = jnp.asarray(pcm[..., : pcm.shape[-1] - pcm.shape[-1] % 1024])
    out = {}

    def h(arr):
        return hashlib.sha256(np.asarray(arr).tobytes()).hexdigest()[:32]

    modes = {
        "at3_full": dict(frame_bytes=384, js=False, no_gain_control=False,
                         no_tonal=False),
        "at3_plain": dict(frame_bytes=384, js=False, no_gain_control=True,
                          no_tonal=True),
        "at3_js": dict(frame_bytes=192, js=True, no_gain_control=False,
                       no_tonal=False),
    }
    for name, kw in modes.items():
        frames = jax.vmap(lambda p: encode_frames_bytes(p, **kw))(x3)
        out[name] = h(jax.device_get(frames))

    from atracdenc_tpu.cli import _merge_channel_planes
    from atracdenc_tpu.models.atrac1.encoder import encode_frames as at1_enc
    from atracdenc_tpu.models.atrac1 import frame as at1_frame
    x1 = pcm[0][:, : pcm.shape[-1] - pcm.shape[-1] % 512]
    planes1 = jax.device_get(at1_enc(jnp.asarray(x1)))
    for k in ("clip_count", "clip_max"):
        planes1.pop(k, None)
    out["at1"] = h(at1_frame.pack(_merge_channel_planes(planes1)))

    from atracdenc_tpu.models.atrac3p.encoder import encode_track as at3p_enc
    from atracdenc_tpu.models.atrac3p import frame as at3p_frame
    planes_p = at3p_enc(pcm[0][:, : pcm.shape[-1] - pcm.shape[-1] % 2048])
    out["at3p"] = h(at3p_frame.pack(planes_p, pcm.shape[1]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true")
    ap.add_argument("--platform-key", default=None)
    args = ap.parse_args()

    import jax
    plat = args.platform_key or jax.default_backend()
    got = compute_hashes()

    if args.update:
        all_h = {}
        if os.path.exists(HASH_FILE):
            all_h = json.load(open(HASH_FILE))
        all_h[plat] = got
        json.dump(all_h, open(HASH_FILE, "w"), indent=1)
        print(f"updated {HASH_FILE} [{plat}]: {json.dumps(got, indent=1)}")
        return

    want = json.load(open(HASH_FILE)).get(plat)
    if want is None:
        print(f"no stored hashes for platform {plat}; run --update first")
        sys.exit(2)
    bad = {k: (want.get(k), got.get(k)) for k in got
           if want.get(k) != got.get(k)}
    if bad:
        for k, (w, g) in bad.items():
            print(f"MISMATCH {k}: want {w} got {g}")
        sys.exit(1)
    print(f"selfcheck OK [{plat}]: {len(got)} modes byte-identical")


if __name__ == "__main__":
    main()
