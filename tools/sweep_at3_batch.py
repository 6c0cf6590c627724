"""Batch-shape sweep for the ATRAC3 end-to-end encode path (ROADMAP A2).

Measures steady-state stereo frames/s of the fused device pipeline
(encode_frames -> pack_device_batch, outputs copied to the host) across (streams, frames-per-stream) grid points, to find where
per-dispatch overhead amortizes and HBM fills.

  python tools/sweep_at3_batch.py [--iters 4] [--grid 32x256,64x256,...]
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


DEFAULT_GRID = ("32x256", "64x256", "128x256", "32x512", "64x512",
                "128x512", "32x1024", "64x1024", "256x256")


def main():
    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--grid", default=",".join(DEFAULT_GRID))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac3.encoder import encode_frames
    from atracdenc_tpu.models.atrac3.device_pack import pack_device_batch


    print(f"backend: {jax.default_backend()}")
    rng = np.random.default_rng(42)

    def measure(streams, nframes):
        t = 1024 * nframes
        n = np.arange(t, dtype=np.float64)
        base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
        pcm = np.clip(
            base[None, None, :] * np.asarray([1.0, 0.8])[None, :, None]
            + 0.05 * rng.standard_normal((streams, 2, t)), -1, 1
        ).astype(np.float32)
        x = jnp.asarray(pcm)
        batched = jax.jit(lambda xs: pack_device_batch(
            jax.vmap(lambda p: encode_frames(
                p, frame_bytes=384, js=False,
                no_gain_control=False, no_tonal=False))(xs), 384, False))
        try:
            out = jax.device_get(batched(x))  # compile + warm
        except Exception as exc:
            return None, str(exc)[:100]
        pending = None
        t0 = time.perf_counter()
        for _ in range(args.iters):
            nxt = batched(x)
            if pending is not None:
                out = jax.device_get(pending)
            pending = nxt
        out = jax.device_get(pending)
        del out
        dt = (time.perf_counter() - t0) / args.iters
        return streams * nframes / dt, None

    for spec in args.grid.split(","):
        s, f = (int(v) for v in spec.split("x"))
        fps, err = measure(s, f)
        if fps is None:
            print(f"{s:4d} x {f:5d}: FAILED {err}")
        else:
            print(f"{s:4d} x {f:5d} ({s * f:7d} frames): "
                  f"{fps:10.0f} frames/s  ({fps / 1046.0:6.1f}x ref)")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
