"""Device timing for the profilers: wall time closed by block_until_ready.

JAX dispatch is asynchronous, so every timing waits for the outputs of
the last call inside the timed region.
"""
import time

import jax

__all__ = ["drain", "measure", "make_timeit"]


def drain(out):
    """Wait until every array in `out` is computed."""
    jax.block_until_ready(out)


def measure(fn, *args, iters=8):
    """Seconds per call of jitted `fn(*args)`: the best of two windows of
    `iters` back-to-back calls, after one warm-up (compile) call."""
    drain(fn(*args))
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        drain(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def make_timeit(iters=8, unit_items=None):
    """Returns timeit(name, fn, *args) printing `name  X ms [rate]`."""

    def timeit(name, fn, *a):
        dt = measure(fn, *a, iters=iters)
        line = f"{name:32s} {dt * 1e3:9.2f} ms"
        if unit_items:
            line += f"   {unit_items / max(dt, 1e-9):12.0f} items/s"
        print(line, flush=True)
        out = fn(*a)
        drain(out)
        return out

    return timeit
