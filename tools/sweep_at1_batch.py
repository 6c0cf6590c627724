"""Batch-shape sweep for the ATRAC1 end-to-end encode path (ROADMAP A2).

Measures steady-state AT1 units/s (one unit = 512 samples of one channel)
of the fused device pipeline (encode_frames -> pack_device) across
(streams, frames-per-stream) grid points, to find where per-dispatch
overhead amortizes and device memory fills.

  python tools/sweep_at1_batch.py [--grid 8x512,32x512,...]
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

REF_AT1_UNITS_PER_S = 11670.0

DEFAULT_GRID = ("8x512", "16x512", "32x512", "64x512", "32x1024", "64x1024",
                "128x512")


def main():
    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--grid", default=",".join(DEFAULT_GRID))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac1.encoder import encode_frames
    from atracdenc_tpu.models.atrac1.device_pack import pack_device

    print(f"backend: {jax.default_backend()}")
    rng = np.random.default_rng(42)

    def measure(streams, nframes):
        t = 512 * nframes
        n = np.arange(t, dtype=np.float64)
        base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
        pcm = np.clip(
            base[None, None, :] * np.asarray([1.0, 0.8])[None, :, None]
            + 0.05 * rng.standard_normal((streams, 2, t)), -1, 1
        ).astype(np.float32)
        x = jnp.asarray(pcm)
        units = streams * 2 * nframes

        def one(p):
            planes = encode_frames(p)
            merged = {k: jnp.swapaxes(v, 0, 1).reshape((-1,) + v.shape[2:])
                      for k, v in planes.items()}
            return pack_device(merged)

        batched = jax.jit(lambda xs: jax.vmap(one)(xs))
        try:
            out = jax.device_get(batched(x))
        except Exception as exc:
            print(f"{streams:4d} x {nframes:5d}: FAILED {type(exc).__name__}:"
                  f" {str(exc)[:120]}")
            return
        pending = None
        t0 = time.perf_counter()
        for _ in range(args.iters):
            nxt = batched(x)
            if pending is not None:
                out = jax.device_get(pending)
            pending = nxt
        out = jax.device_get(pending)
        rate = units / ((time.perf_counter() - t0) / args.iters)
        print(f"{streams:4d} x {nframes:5d} ({units:7d} units): "
              f"{rate:10.0f} units/s  ({rate / REF_AT1_UNITS_PER_S:6.1f}x)")

    for spec in args.grid.split(","):
        s, f = spec.lower().split("x")
        measure(int(s), int(f))


if __name__ == "__main__":
    main()
