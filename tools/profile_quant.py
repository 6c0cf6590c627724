"""Micro-profiler for the ATRAC3 quant-memo substages (PERF.md evidence).

Splits bitalloc.quant_tensors into: plain 8-lane costs, the EA overlay
(rank + permutation + scan) per group, and the wl==1 pair codebook, to
rank where the 160 ms (32x256 batch) actually goes.
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
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac3 import bitalloc, tables as T
    from atracdenc_tpu.models.atrac3.encoder import _GATHER_MASK
    from atracdenc_tpu.ops.quant import quant_blocks

    rng = np.random.default_rng(0)
    n = args.streams * 2 * args.frames            # channel-frames
    scaled = jnp.asarray(
        (rng.standard_normal((n, 32, 128)) * 0.3).astype(np.float32)
        * np.asarray(_GATHER_MASK, np.float32))
    print(f"{n} channel-frames;  EA groups: {bitalloc._ea_groups()}")

    def timeit(name, fn, *a):
        from tools._timing import measure
        try:
            dt = measure(fn, *a, iters=max(args.iters, 8))
        except Exception as exc:
            print(f"{name}: FAILED {type(exc).__name__}: {str(exc)[:100]}")
            return None
        print(f"{name:34s} {dt * 1e3:9.2f} ms")
        out = fn(*a)
        from tools._timing import drain
        drain(out)
        return out

    timeit("plain_costs_xla", jax.jit(
        lambda s: bitalloc._plain_costs_xla(s, _GATHER_MASK)), scaled)

    maxq = jnp.asarray(T.MAX_QUANT)
    for b, e, ln in bitalloc._ea_groups():
        def ea_one(s, b=b, e=e, ln=ln):
            sub = jnp.broadcast_to(s[..., b:e, None, :ln],
                                   (n, e - b, 7, ln))
            subv = jnp.broadcast_to(_GATHER_MASK[b:e, None, :ln],
                                    (e - b, 7, ln))
            subm = jnp.broadcast_to(maxq[1:], (n, e - b, 7))
            ones = jnp.ones(subm.shape, bool)
            return quant_blocks(sub, subv, subm, ones)
        timeit(f"ea_group[{b}:{e}] L={ln} (7 lanes)", jax.jit(ea_one),
               scaled)

    timeit("quant_tensors FULL", jax.jit(
        lambda s: bitalloc.quant_tensors(s, _GATHER_MASK)), scaled)
    timeit("final_mantissas(wl=4)", jax.jit(
        lambda s: bitalloc.final_mantissas(
            s, _GATHER_MASK, jnp.full((n, 32), 4, jnp.int32))), scaled)


if __name__ == "__main__":
    main()
