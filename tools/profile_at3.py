"""Stage-level profiler for the ATRAC3 encode pipeline (PERF.md evidence).

Times each pipeline stage as its own jitted function (block_until_ready
around exactly one stage), plus the fused end-to-end path.  Numbers feed
the roofline table in PERF.md.

  python tools/profile_at3.py [--streams 32] [--seconds 47.5] [--iters 4]
                              [--trace /tmp/xplane]  # jax.profiler trace

Runs on the default backend; one JAX process per card.
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
    ap.add_argument("--seconds", type=float, default=47.5)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from functools import partial
    from atracdenc_tpu.models.atrac3 import encoder as E
    from atracdenc_tpu.models.atrac3 import bitalloc, tonal, gain
    from atracdenc_tpu.models.atrac3.device_pack import pack_device
    from atracdenc_tpu.models.atrac3.mdct import (mdct_frames, gain_divisors,
                                                  first_level_scale)
    from atracdenc_tpu.models.atrac3 import tables as T

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
        from tools._timing import measure, drain
        try:
            dt = measure(fn, *a, iters=max(args.iters, 8))
        except Exception as exc:                  # OOM at big batches: keep
            print(f"{name:28s}   FAILED: {str(exc)[:120]}")
            return None
        print(f"{name:28s} {dt * 1e3:9.2f} ms   "
              f"{frames / max(dt, 1e-9):12.0f} frames/s-equiv")
        out = fn(*a)
        drain(out)
        return out

    # --- stage functions (each jitted standalone) ---
    @jax.jit
    def st_bands(xs):
        return jax.vmap(E.band_frames)(xs)

    @jax.jit
    def st_gain(bands):
        def one(b):
            st = E.init_state(b.shape[0])
            lv, lc, npts, _ = gain.gain_control(b, ctx=st["gain"],
                                                next_head=None)
            div = gain_divisors(lv, lc, npts)
            sc = first_level_scale(lv, npts)
            gsf, es = gain.energy_scale(b, div, sc,
                                        prev_half=st["mdct_prev"],
                                        prev_overlap_init=st["next_overlap"])
            specs = mdct_frames(b, div, sc, prev_half=st["mdct_prev"])
            return specs, gsf
        return jax.vmap(one)(bands)

    @jax.jit
    def st_tonal(specs):
        def one(s):
            flat = tonal.flatness_per_bfu(s * s)
            s2, tp = tonal.extract(s, flat)
            return s2, tonal.scale_groups(tp)
        return jax.vmap(one)(specs)

    @jax.jit
    def st_scale(specs):
        from atracdenc_tpu.ops import scale as scale_ops
        def one(s):
            blocks = E.gather_bfu_blocks(s)
            return scale_ops.scale_blocks(blocks, E._GATHER_MASK,
                                          E._SCALE_TABLE)
        return jax.vmap(one)(specs)

    @jax.jit
    def st_quant(scaled):
        return jax.vmap(lambda s: bitalloc.quant_tensors(
            s, E._GATHER_MASK))(scaled)

    @jax.jit
    def st_alloc(qt, sfi, gsf, energy):
        def one(qt, sfi, gsf, energy):
            c, f = sfi.shape[:2]
            spread = E.spread_from_sfi(sfi)
            target = jnp.full((c, f), 1482, jnp.int32)
            loud = jnp.full((c, f), 1.0, jnp.float32)
            return bitalloc.allocate(qt, sfi, gsf, energy, spread, loud,
                                     target)
        return jax.vmap(one)(qt, sfi, gsf, energy)

    @jax.jit
    def st_alloc_tonal(qt, sfi, gsf, energy, specs):
        """allocate() with the tonal dry-run cost INSIDE the bisection —
        the full-mode configuration (the plain st_alloc stage uses the
        constant empty-tonal header)."""
        def one(qt, sfi, gsf, energy, specs):
            c, f = sfi.shape[:2]
            flat = tonal.flatness_per_bfu(specs * specs)
            _, tp = tonal.extract(specs, flat)
            tonal_planes = tonal.scale_groups(tp)
            bfu_oh = jax.nn.one_hot(tonal_planes["bfu"], 32, dtype=jnp.int32)
            tonal_counts = jnp.sum(
                bfu_oh * tonal_planes["active"][..., None].astype(jnp.int32),
                axis=-2)
            spread = E.spread_from_sfi(sfi)
            target = jnp.full((c, f), 1482, jnp.int32)
            loud = jnp.full((c, f), 1.0, jnp.float32)
            return bitalloc.allocate(qt, sfi, gsf, energy, spread, loud,
                                     target, tonal_counts=tonal_counts,
                                     tonal_bits_fn=tonal.make_cost_fn(
                                         tonal_planes))
        return jax.vmap(one)(qt, sfi, gsf, energy, specs)

    @jax.jit
    def st_mant(scaled, wl):
        return jax.vmap(lambda s, w: bitalloc.final_mantissas(
            s, E._GATHER_MASK, w))(scaled, wl)

    @jax.jit
    def st_pack(planes):
        from atracdenc_tpu.models.atrac3.device_pack import pack_device_batch
        return pack_device_batch(planes, 384, False)

    @jax.jit
    def st_e2e(xs):
        return jax.vmap(lambda p: E.encode_frames_bytes(
            p, frame_bytes=384, js=False, no_gain_control=False,
            no_tonal=False))(xs)

    ctx = jax.profiler.trace(args.trace) if args.trace else None
    if ctx:
        ctx.__enter__()

    bands = timeit("pqf/bands", st_bands, xs)
    specs, gsf = timeit("gain+mdct", st_gain, bands)
    timeit("tonal", st_tonal, specs)
    sfi, scaled, energy = timeit("scale", st_scale, specs)
    qt = timeit("quant_tensors", st_quant, scaled)
    res = timeit("allocate(bisect)", st_alloc, qt, sfi, gsf, energy)
    timeit("allocate(+tonal cost)", st_alloc_tonal, qt, sfi, gsf, energy,
           specs)
    if res is not None:
        nb, mode, wl = res
        timeit("final_mantissas", st_mant, scaled, wl)
    planes = jax.jit(lambda xs: jax.vmap(lambda p: E.encode_frames(
        p, frame_bytes=384, js=False, no_gain_control=False,
        no_tonal=False))(xs))(xs)
    timeit("device_pack", st_pack, planes)
    out = timeit("E2E fused bytes", st_e2e, xs)

    # device->host transfer of the result
    t0 = time.perf_counter()
    np.asarray(jax.device_get(out))
    print(f"{'bytes transfer out':28s} "
          f"{(time.perf_counter() - t0) * 1e3:9.2f} ms")

    if ctx:
        ctx.__exit__(None, None, None)
        print("trace written to", args.trace)


if __name__ == "__main__":
    main()
