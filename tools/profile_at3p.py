"""Stage-level profiler for the ATRAC3+ encode pipeline (PERF.md evidence).

Times each pipeline stage as its own jitted function, plus the production
`run` path bench.py measures (core + host tail + device pack).

  python tools/profile_at3p.py [--streams 4] [--frames 128] [--iters 3]
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
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac3p import encoder as E
    from atracdenc_tpu.models.atrac3p import gha, pqf
    from atracdenc_tpu.models.atrac3p import tables as T
    from atracdenc_tpu.models.atrac3p.device_pack import pack_device
    from atracdenc_tpu.models.atrac3p.mdct import mdct_frames
    from atracdenc_tpu.ops import scale as scale_ops

    rng = np.random.default_rng(0)
    t = args.frames * T.NUM_SAMPLES
    n = np.arange(t)
    base = 0.3 * np.sin(2 * np.pi * 997 * n / 44100)
    pcm = np.stack([base + 0.05 * rng.standard_normal(t),
                    0.7 * base + 0.05 * rng.standard_normal(t)]
                   ).astype(np.float32)
    x = jnp.asarray(pcm)
    frames = args.frames
    print(f"one stream: 2 ch x {t} samples ({frames} frames); the final "
          f"E2E row batches {args.streams} streams (vmapped fused bytes)")

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

    bands = timeit("pqf/bands", jax.jit(E.band_frames), x)
    tones = timeit("gha.extract", jax.jit(gha.extract), bands)
    resid = timeit("gha.subtract", jax.jit(gha.subtract), bands, tones)

    @jax.jit
    def st_mdct(resid):
        res = jnp.pad(resid[:, :-1], ((0, 0), (1, 0), (0, 0), (0, 0)))
        return mdct_frames(res * T.RESIDUAL_SCALE)

    specs = timeit("mdct", st_mdct, resid)

    @jax.jit
    def st_scale(specs):
        blocks = E.gather_qu_blocks(specs)
        return scale_ops.scale_blocks(blocks, E._GATHER_MASK, E._SCALE_TABLE)

    sfi, scaled, _ = timeit("scale", st_scale, specs)

    @jax.jit
    def st_mant_cost(scaled):
        inv_mant = jnp.asarray(T.INV_MANT_TAB)[jnp.asarray(T.FIXED_WORDLEN)]
        mant = jnp.round(scaled * inv_mant[:, None]).astype(jnp.int32)
        mant = jnp.where(E._GATHER_MASK, mant, 0)
        costs = []
        for qu in range(32):
            wl = int(T.FIXED_WORDLEN[qu])
            qc = [E._qu_table_cost(mant[..., qu, :], qu, 7 * i + wl - 1)
                  for i in range(8)]
            costs.append(jnp.stack(qc, axis=-1))
        cost = jnp.stack(costs, axis=-2)
        return mant, cost

    timeit("mant+vlc_cost", st_mant_cost, scaled)

    core = jax.jit(lambda p: E._encode_core(p, gha_mask=7))
    timeit("core fused (gha on)", core, x)
    core_off = jax.jit(lambda p: E._encode_core(p, gha_mask=None))
    timeit("core fused (gha off)", core_off, x)

    # device finish + pack on one stream
    fin = jax.jit(lambda p: E._finish_planes_device(
        E._encode_core(p, gha_mask=7), 2))
    planes = timeit("core+finish (device)", fin, x)
    timeit("pack_device", jax.jit(lambda p: pack_device(p, 2)), planes)

    # the production path bench.py times: the stream-vmapped fused bytes
    # pipeline at --streams width
    xs = jnp.broadcast_to(x, (args.streams,) + x.shape)
    batched = jax.jit(lambda xs: jax.vmap(
        lambda p: E.encode_frames_bytes(p, 2, gha_mask=7))(xs))
    from tools._timing import measure
    dt = measure(batched, xs, iters=max(args.iters, 4))
    print(f"{'E2E fused bytes (batched)':28s} {dt * 1e3:9.2f} ms   "
          f"{args.streams * frames / max(dt, 1e-9):12.0f} frames/s "
          f"({args.streams} streams)")


if __name__ == "__main__":
    main()
