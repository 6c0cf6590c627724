"""Batch corpus transcoder: encode many WAV files in one process.

The reference is a one-file-at-a-time CLI; this drives the batched device
pipeline across a corpus: tracks are chunked to fixed frame counts (so XLA
compilations are reused across files), and frame serialization runs ON
DEVICE (models/*/device_pack.py) so only final frame bytes leave the chip;
the host only writes container headers.

    python -m atracdenc_tpu.tools.transcode --codec atrac3 --out-dir enc/ *.wav
"""
import argparse
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="atracdenc-tpu-transcode")
    p.add_argument("inputs", nargs="+", help="44.1 kHz/16-bit WAV files")
    p.add_argument("--codec", choices=("atrac1", "atrac3", "atrac3plus"),
                   default="atrac3")
    p.add_argument("--bitrate", type=int, default=0)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--chunk-frames", type=int, default=512)
    p.add_argument("--resume", action="store_true",
                   help="skip inputs whose output already exists (outputs "
                        "are written atomically via a temp file, so an "
                        "interrupted run never leaves a partial container)")
    args = p.parse_args(argv)

    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from atracdenc_tpu.io import audio
    from atracdenc_tpu.containers import oma, aea
    os.makedirs(args.out_dir, exist_ok=True)

    t0 = time.perf_counter()
    total_samples = 0
    for path in args.inputs:
        name0 = os.path.splitext(os.path.basename(path))[0]
        ext = ".aea" if args.codec == "atrac1" else ".oma"
        final = os.path.join(args.out_dir, name0 + ext)
        if args.resume and os.path.exists(final):
            print(f"skip {path}: {final} exists")
            continue
        pcm, rate = audio.read(path)
        if rate != 44100:
            print(f"skip {path}: unsupported sample rate {rate}",
                  file=sys.stderr)
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        channels = pcm.shape[0]
        total_samples += pcm.shape[1]

        if args.codec == "atrac1":
            from atracdenc_tpu.models.atrac1.encoder import encode_track
            from atracdenc_tpu.models.atrac1.device_pack import pack_device
            import jax.numpy as jnp
            import numpy as np
            planes = encode_track(pcm)
            merged = {k: jnp.swapaxes(jnp.asarray(v), 0, 1).reshape(
                (-1,) + v.shape[2:]) for k, v in planes.items()}
            frames = np.asarray(pack_device(merged))
            out = os.path.join(args.out_dir, name + ".aea")
            aea.write(out + ".tmp", frames, channels, pcm.shape[1])
            os.replace(out + ".tmp", out)
        elif args.codec == "atrac3":
            from atracdenc_tpu.models.atrac3 import tables as T3
            from atracdenc_tpu.models.atrac3.encoder import encode_track
            from atracdenc_tpu.models.atrac3 import frame as at3_frame
            _, fsz, js = T3.container_params_for_bitrate(args.bitrate * 1024)
            import jax.numpy as jnp
            import numpy as np
            from atracdenc_tpu.models.atrac3.device_pack import pack_device
            planes = encode_track(pcm, frame_bytes=fsz, js=js,
                                  no_gain_control=False, no_tonal=False,
                                  chunk_frames=args.chunk_frames)
            frames = np.asarray(pack_device(
                {k: jnp.asarray(v) for k, v in planes.items()}, fsz, js=js))
            out = os.path.join(args.out_dir, name + ".oma")
            oma.write(out + ".tmp", frames, oma.CODEC_ATRAC3, fsz,
                      channels=channels, joint_stereo=js)
            os.replace(out + ".tmp", out)
        else:
            from atracdenc_tpu.models.atrac3p import tables as TP
            from atracdenc_tpu.models.atrac3p.encoder import encode_track
            from atracdenc_tpu.models.atrac3p import frame as at3p_frame
            import jax.numpy as jnp
            import numpy as np
            from atracdenc_tpu.models.atrac3p.device_pack import pack_device
            planes = encode_track(pcm)
            dev_planes = {k: (jnp.asarray(v) if not isinstance(v, dict)
                              else {kk: jnp.asarray(vv)
                                    for kk, vv in v.items()})
                          for k, v in planes.items()}
            frames = np.asarray(pack_device(dev_planes, channels))
            out = os.path.join(args.out_dir, name + ".oma")
            oma.write(out + ".tmp", frames, oma.CODEC_ATRAC3PLUS,
                      TP.FRAME_BYTES, channels=channels)
            os.replace(out + ".tmp", out)
        print(f"{path} -> {out}")

    dt = time.perf_counter() - t0
    if total_samples:
        print(f"{len(args.inputs)} files, {total_samples / 44100:.1f}s of "
              f"audio in {dt:.1f}s ({total_samples / 44100 / dt:.1f}x "
              "realtime)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
