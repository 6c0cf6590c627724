"""Honest stage profiler for the ATRAC1 encode pipeline (tools/_timing.py).

  python tools/profile_at1.py [--streams 8] [--frames 512]
"""
import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac1 import encoder as E
    from atracdenc_tpu.models.atrac1 import filterbank, tables as T
    from atracdenc_tpu.models.atrac1.bitalloc import allocate
    from atracdenc_tpu.models.atrac1.device_pack import pack_device
    from atracdenc_tpu.ops import scale as scale_ops, psy
    from atracdenc_tpu.ops.transient import transient_mask
    from atracdenc_tpu.models.atrac1.mdct import mdct_frames
    from tools._timing import make_timeit, drain, measure

    rng = np.random.default_rng(0)
    t = args.frames * 512
    n = np.arange(t)
    base = 0.4 * np.sin(2 * np.pi * 997 * n / 44100)
    pcm = np.stack([base + 0.05 * rng.standard_normal(t),
                    0.7 * base + 0.05 * rng.standard_normal(t)]
                   ).astype(np.float32)
    xs = jnp.asarray(np.broadcast_to(pcm, (args.streams,) + pcm.shape))
    units = args.streams * 2 * args.frames
    print(f"batch: {args.streams} x 2ch x {args.frames} frames "
          f"({units} units)", flush=True)
    timeit = make_timeit(iters=args.iters)

    vm = lambda fn: jax.jit(lambda a: jax.vmap(fn)(a))

    bands = timeit("filterbank", vm(filterbank.analysis), xs)

    def st_masks(bands):
        low, mid, hi = bands
        m_low = transient_mask(low, 128)
        m_mid = transient_mask(E._invert_spectrum(mid), 128)
        m_hi = transient_mask(E._invert_spectrum(hi), 256)
        return jnp.stack([m_low, m_mid, m_hi], axis=-1)
    masks = timeit("transient masks", vm(st_masks), bands)

    def st_mdct(args_):
        (low, mid, hi), masks = args_
        c = low.shape[0]
        f = masks.shape[1]
        return jnp.concatenate([
            mdct_frames(low.reshape(c, f, 128), masks[..., 0], 0),
            mdct_frames(mid.reshape(c, f, 128), masks[..., 1], 1),
            mdct_frames(hi.reshape(c, f, 256), masks[..., 2], 2),
        ], axis=-1)
    specs = timeit("mdct", vm(st_mdct), (bands, masks))

    def st_gather_scale(args_):
        specs, masks = args_
        blocks = E.gather_bfu_blocks(specs, masks)
        return scale_ops.scale_blocks(blocks, E._GATHER_MASK,
                                      jnp.asarray(T.SCALE_TABLE))
    sse = timeit("gather+scale", vm(st_gather_scale), (specs, masks))
    sfi, scaled, energy = sse

    def st_alloc(args_):
        sfi, energy, masks = args_
        loud = jnp.ones(sfi.shape[:2], jnp.float32)
        return allocate(sfi, energy, masks, loud)
    alloc = timeit("allocate", vm(st_alloc), (sfi, energy, masks))
    bfu_idx, wordlen = alloc

    timeit("quant_mantissas", vm(lambda a: scale_ops.quant_mantissas(*a)),
           (scaled, wordlen))

    def full(p):
        planes = E.encode_frames(p)
        merged = {k: jnp.swapaxes(v, 0, 1).reshape((-1,) + v.shape[2:])
                  for k, v in planes.items()}
        return pack_device(merged)
    fullb = jax.jit(lambda a: jax.vmap(full)(a))
    dt = measure(fullb, xs, iters=args.iters)
    print(f"{'E2E encode+pack':32s} {dt * 1e3:9.2f} ms   "
          f"{units / max(dt, 1e-9):12.0f} units/s", flush=True)

    def enc_only(p):
        return E.encode_frames(p)
    dt = measure(jax.jit(lambda a: jax.vmap(enc_only)(a)), xs,
                 iters=args.iters)
    print(f"{'encode (no pack)':32s} {dt * 1e3:9.2f} ms   "
          f"{units / max(dt, 1e-9):12.0f} units/s", flush=True)


if __name__ == "__main__":
    main()
