"""Sub-stage profiler for the ATRAC3 gain-control + MDCT chain.

tools/profile_at3.py showed gain+mdct is the dominant encode stage; this
drills into it (each sub-stage jitted standalone, block_until_ready
timing) so PERF.md can name the exact hot spot.

  python tools/profile_gain.py [--streams 32] [--seconds 11.9] [--iters 4]
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=11.9)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac3 import encoder as E
    from atracdenc_tpu.models.atrac3 import gain
    from atracdenc_tpu.models.atrac3.mdct import (mdct_frames, gain_divisors,
                                                  first_level_scale)

    rng = np.random.default_rng(0)
    t = int(args.seconds * 44100) // 1024 * 1024
    n = np.arange(t)
    base = 0.3 * np.sin(2 * np.pi * 997 * n / 44100)
    pcm = np.stack([base + 0.05 * rng.standard_normal(t),
                    0.7 * base + 0.05 * rng.standard_normal(t)]
                   ).astype(np.float32)
    xs = jnp.asarray(np.broadcast_to(pcm, (args.streams,) + pcm.shape))
    frames = args.streams * (t // 1024)
    print(f"batch: {args.streams} streams x {t} samples "
          f"({frames} stereo frames)")

    def timeit(name, fn, *a):
        from tools._timing import measure
        try:
            dt = measure(fn, *a, iters=max(args.iters, 8))
        except Exception as exc:
            print(f"{name}: FAILED {type(exc).__name__}: {str(exc)[:100]}")
            return None
        print(f"{name:28s} {dt * 1e3:9.2f} ms   "
              f"{frames / max(dt, 1e-9):12.0f} frames/s-equiv")
        out = fn(*a)
        from tools._timing import drain
        drain(out)
        return out

    bands = jax.block_until_ready(
        jax.jit(jax.vmap(E.band_frames))(xs))

    def vm(fn):
        return jax.jit(jax.vmap(fn))

    # the upsampler input assembly + matmuls, isolated (shared with
    # gain.gain_control so the profiler always measures the real assembly)
    def up_in_of(b):
        return gain.assemble_up_in(b, gain.init_ctx(b.shape[0]))

    up_in = timeit("assemble up_in", vm(up_in_of), bands)
    region, hfr = timeit("upsample_region (matmuls)",
                         vm(gain.upsample_region), up_in)
    ag = timeit("analyze_gain", vm(gain.analyze_gain), region)

    def curves_of(b):
        c = b.shape[0]
        st = E.init_state(c)
        return gain.gain_control(b, ctx=st["gain"], next_head=None)

    lv, lc, npts, _ = timeit("gain_control (full)", vm(curves_of), bands)

    div = timeit("gain_divisors", vm(gain_divisors), lv, lc, npts)
    sc = timeit("first_level_scale", vm(first_level_scale), lv, npts)

    def es_of(b, d, s):
        c = b.shape[0]
        st = E.init_state(c)
        return gain.energy_scale(b, d, s, prev_half=st["mdct_prev"],
                                 prev_overlap_init=st["next_overlap"])

    timeit("energy_scale", vm(es_of), bands, div, sc)

    def md_of(b, d, s):
        c = b.shape[0]
        st = E.init_state(c)
        return mdct_frames(b, d, s, prev_half=st["mdct_prev"])

    timeit("mdct_frames", vm(md_of), bands, div, sc)


if __name__ == "__main__":
    main()
