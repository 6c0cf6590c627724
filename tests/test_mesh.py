"""Multi-device sharding correctness on the 8-device virtual CPU mesh.

Round-1 only asserted output SHAPES; these tests assert that sharded
execution produces byte/bit-identical results to single-device execution
for every (dp, sp) factorization of the mesh — the property that makes the
(stream, time) sharding a pure throughput knob.  (Reference analog: the
fake-backend discipline of test/ut/encode_ut.cpp.)
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from atracdenc_tpu.parallel import mesh as M

pytestmark = pytest.mark.slow


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Deserializing multi-device executables from the persistent jit
    cache segfaults XLA-CPU mid-suite (observed twice at
    compilation_cache.get_executable_and_time loading the sharded AT3
    bytes executable).  Sharded compiles skip the on-disk cache; every
    other module keeps it."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def _pcm(s, t, seed=0):
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    return np.clip(base[None, None, :]
                   + 0.05 * rng.standard_normal((s, 2, t)),
                   -1, 1).astype(np.float32)


_mesh = M.make_mesh


@pytest.mark.parametrize("dp,sp", [(8, 1), (2, 4), (1, 8)])
def test_at3_bytes_sharded_equal_unsharded(dp, sp):
    pcm = _pcm(max(dp, 2) * 2, 1024 * 2 * sp)
    ref = np.asarray(M.encode_batch_at3_bytes_sharded(
        jnp.asarray(pcm), _mesh(1, 1)))
    out = np.asarray(M.encode_batch_at3_bytes_sharded(
        jnp.asarray(pcm), _mesh(dp, sp)))
    assert (ref == out).all()


@pytest.mark.parametrize("dp,sp", [(2, 4)])
def test_at1_planes_sharded_equal_unsharded(dp, sp):
    pcm = _pcm(4, 512 * 2 * sp, seed=1)
    ref = M.encode_batch_sharded(jnp.asarray(pcm), _mesh(1, 1))
    out = M.encode_batch_sharded(jnp.asarray(pcm), _mesh(dp, sp))
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), np.asarray(out[k])), k


@pytest.mark.parametrize("dp,sp", [(2, 4)])
def test_at3_js_bytes_sharded_equal_unsharded(dp, sp):
    """Joint stereo: M/S matrixing, the loudness byte-budget shift and the
    reversed channel-1 deposit all ride the (dp, sp) shardings."""
    pcm = _pcm(max(dp, 2) * 2, 1024 * 2 * sp, seed=3)
    ref = np.asarray(M.encode_batch_at3_bytes_sharded(
        jnp.asarray(pcm), _mesh(1, 1), js=True, frame_bytes=192))
    out = np.asarray(M.encode_batch_at3_bytes_sharded(
        jnp.asarray(pcm), _mesh(dp, sp), js=True, frame_bytes=192))
    assert (ref == out).all()


def test_at1_decode_roundtrip_sharded():
    """Encode -> decode entirely on the mesh; dp-sharded decode matches
    single-device decode to a few ulps (raw conv floats shift with the
    local batch size — see decode_batch_at1_sharded; measured 2.7e-7)."""
    pcm = _pcm(4, 512 * 4, seed=4)
    planes = M.encode_batch_sharded(jnp.asarray(pcm), _mesh(2, 4))
    dec = np.asarray(M.decode_batch_at1_sharded(planes, _mesh(4, 2)))
    dec1 = np.asarray(M.decode_batch_at1_sharded(planes, _mesh(1, 1)))
    assert np.max(np.abs(dec - dec1)) <= 1e-6
    assert dec.shape == (4, 2, 512 * 4)
    # and the round trip reconstructs the signal (AT1 is ~perceptually
    # lossless on tones; loose energy sanity only)
    assert np.sqrt((dec ** 2).mean()) > 0.1 * np.sqrt((pcm ** 2).mean())


def test_at3p_wideband_gha_sharded_equal_unsharded():
    """The wideband-GHA strategy (matching pursuit on the raw 2048 window
    + PQF projection) through the sharded core."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from atracdenc_tpu.models.atrac3p import encoder as PE
    from atracdenc_tpu.models.atrac3p import tables as PT

    sp = 2
    pcm = _pcm(2, PT.NUM_SAMPLES * 2 * sp, seed=5)

    def enc(xs):
        return jax.vmap(lambda p: PE._encode_core(
            p, gha_mask=7, wb_refine=True))(xs)

    outs = {}
    for name, m in (("sharded", _mesh(2, sp)), ("single", _mesh(1, 1))):
        in_sh = NamedSharding(m, P("dp", None, "sp"))
        out_sh = NamedSharding(m, P("dp"))
        fn = jax.jit(enc, in_shardings=in_sh, out_shardings=out_sh)
        outs[name] = jax.device_get(fn(jax.device_put(
            jnp.asarray(pcm), in_sh)))
    for a, b in zip(jax.tree.leaves(outs["sharded"]),
                    jax.tree.leaves(outs["single"])):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_16_device_factorization_subprocess():
    """A 16-virtual-device (4, 4) factorization; device count is fixed at
    backend init, so this runs in a subprocess with its own XLA_FLAGS."""
    import os
    import subprocess
    import sys

    code = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, %r)
import numpy as np, jax, jax.numpy as jnp
from atracdenc_tpu.parallel import mesh as M
rng = np.random.default_rng(0)
pcm = (0.25 * rng.standard_normal((4, 2, 512 * 2 * 4))).astype(np.float32)
m = M.make_mesh(4, 4)
m1 = M.make_mesh(1, 1)
out = M.encode_batch_sharded(jnp.asarray(pcm), m)
ref = M.encode_batch_sharded(jnp.asarray(pcm), m1)
for k in ref:
    assert np.array_equal(np.asarray(ref[k]), np.asarray(out[k])), k
print("OK16")
""" % os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK16" in r.stdout
