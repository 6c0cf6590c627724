"""Micro-profiler for the AT3 device serializer substages (PERF.md).

Splits pack_device into: channel field-plane computation (incl. the tonal
section's sort + subgroup scan), and the one-hot bit deposit, to rank
where the pack stage's in-context time goes.
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac3 import device_pack as D
    from atracdenc_tpu.models.atrac3.encoder import encode_frames
    from atracdenc_tpu.ops.bitdeposit import deposit_fields

    rng = np.random.default_rng(0)
    t = 1024 * args.frames
    n = np.arange(t)
    base = 0.3 * np.sin(2 * np.pi * 997 * n / 44100)
    pcm = np.stack([base + 0.05 * rng.standard_normal(t),
                    0.7 * base + 0.05 * rng.standard_normal(t)]
                   ).astype(np.float32)
    xs = jnp.asarray(np.broadcast_to(pcm, (args.streams,) + pcm.shape))
    nfr = args.streams * args.frames
    print(f"batch: {args.streams} x {args.frames} = {nfr} frames")

    planes = jax.jit(lambda xs: jax.vmap(lambda p: encode_frames(
        p, frame_bytes=384, js=False, no_gain_control=False,
        no_tonal=False))(xs))(xs)
    planes = jax.block_until_ready(planes)

    s, c, f = planes["num_bfu"].shape[:3]
    merged = {}
    for k, v in planes.items():
        if k in ("ms_shift", "loudness"):
            merged[k] = v.reshape((s * f,) + v.shape[2:])
        else:
            vv = jnp.swapaxes(v, 0, 1)
            merged[k] = vv.reshape((c, s * f) + v.shape[3:])

    def timeit(name, fn, *a):
        from tools._timing import measure
        try:
            dt = measure(fn, *a, iters=max(args.iters, 8))
        except Exception as exc:
            print(f"{name}: FAILED {type(exc).__name__}: {str(exc)[:100]}")
            return None
        print(f"{name:32s} {dt * 1e3:9.2f} ms")
        out = fn(*a)
        from tools._timing import drain
        drain(out)
        return out

    ch0 = {k: v[0] for k, v in merged.items()
           if k not in ("loudness", "ms_shift")}

    timeit("tonal_fields (1ch)", jax.jit(lambda p: D._tonal_fields(p)), ch0)
    v, w, o = timeit("channel_fields (1ch)",
                     jax.jit(lambda p: D.channel_fields(p)), ch0)
    print(f"  K = {v.shape[1]} slots")
    timeit("deposit_fields (1ch, 640B)", jax.jit(
        lambda v, w, o: deposit_fields(v, w, o, 384 + 256)), v, w, o)
    timeit("pack_device FULL (2ch)", jax.jit(
        lambda m: D.pack_device(m, 384, False)), merged)


if __name__ == "__main__":
    main()
