"""File-level ATRAC3 encode path for the CLI driver.

Mirrors PrepareAtrac3Encoder + the pump loop (reference: src/main.cpp:367-424,
656-687): bitrate in kbit/s scales by 1024, container auto-selected from the
output extension, OMA/RIFF/RM/RAW writers.
"""
import sys

from . import tables as T


from atracdenc_tpu.utils.operator_log import warn_clipping as _warn_clipping


def encode_file(args, lp4=False):
    from atracdenc_tpu.io import audio
    from atracdenc_tpu.containers import oma, at3, rm, raw
    from . import frame as at3_frame
    from .encoder import encode_track

    pcm, rate = audio.read(args.infile)
    if rate != 44100:
        sys.exit("Unsupported sample rate. Only 44100Hz is supported now")
    channels = pcm.shape[0]

    bitrate_kbit = 64 if lp4 else args.bitrate
    bitrate, frame_size, js = T.container_params_for_bitrate(
        bitrate_kbit * 1024)

    if args.bfuidxconst and not (1 <= args.bfuidxconst <= 32):
        sys.exit("Wrong bfuidxconst value (1...32)")

    if not args.nostdout:
        print(f"Input file: {args.infile}\n Channels: {channels}\n "
              f"SampleRate: {rate}\n Bitrate: {bitrate}")

    progress = None
    if not args.nostdout:
        from atracdenc_tpu.utils.progress import print_progress as progress
    if getattr(args, "exact", False):
        # reference-float-semantics path: byte-identical to the reference
        # binary in every mode (tests/test_at3_exact.py); host NumPy,
        # slower than the batched path
        from .exact_enc import encode_track_exact
        planes = encode_track_exact(pcm, frame_bytes=frame_size, js=js,
                                    no_gain=args.nogaincontrol,
                                    no_tonal=args.notonal,
                                    bfu_idx_const=args.bfuidxconst)
    else:
        planes = encode_track(pcm, frame_bytes=frame_size, js=js,
                              no_gain_control=args.nogaincontrol,
                              no_tonal=args.notonal,
                              bfu_idx_const=args.bfuidxconst,
                              progress=progress)
    _warn_clipping(planes)
    frames = at3_frame.pack(planes, frame_size, js=js)

    if getattr(args, "yaml_log", None) and not args.nogaincontrol:
        import jax, jax.numpy as jnp
        from . import gain, yaml_log
        from .encoder import band_frames
        bands = band_frames(jnp.asarray(
            __import__("numpy").atleast_2d(pcm.astype("float32"))))
        if js and bands.shape[0] == 2:
            bands = jnp.stack([(bands[0] + bands[1]) * 0.5,
                               (bands[0] - bands[1]) * 0.5])
        *_, dbg = gain.gain_control(bands, debug=True)
        with open(args.yaml_log, "w") as fp:
            yaml_log.write(fp, planes, jax.device_get(dbg))

    import os
    container = args.container
    if container is None:
        ext = os.path.splitext(args.outfile)[1].lower()
        container = {".oma": "oma", ".aa3": "oma", ".wav": "riff",
                     ".at3": "riff", ".rm": "rm"}.get(ext, "oma")

    if container == "oma":
        oma.write(args.outfile, frames, oma.CODEC_ATRAC3, frame_size,
                  channels=channels, joint_stereo=js)
    elif container == "riff":
        at3.write_at3(args.outfile, frames, frame_size, joint_stereo=js)
    elif container == "rm":
        rm.write(args.outfile, frames, frame_size, channels=channels,
                 joint_stereo=js)
    elif container == "raw":
        raw.write(args.outfile, frames)
    else:
        sys.exit(f"Unsupported container for ATRAC3: {container}")
