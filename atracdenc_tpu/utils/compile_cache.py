"""Where the persistent XLA compilation cache lives.

One rule for every entry point (CLI, transcoder, bench, smoke test,
profilers): if JAX_COMPILATION_CACHE_DIR is set, JAX reads it and this
module sets no other directory; otherwise the cache is `.jax_cache` in the
checkout, which .gitignore lists.  A fixed path matters because the path
is part of the cache key: a directory that moves never hits.
"""
import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache():
    """Point JAX's persistent compilation cache at the one directory this
    repository uses and return that directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
