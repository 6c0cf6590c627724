"""What running on a GPU requires of the code, checked on the CPU.

  * float contractions pin their precision: on Hopper XLA's default for
    float32 dots is TF32 (about 10 mantissa bits), which would move
    rate-control decisions and therefore bytes;
  * no source names a TPU-only API or branches on a TPU platform;
  * the persistent compile cache lives where the one helper says;
  * the GPU-only scripts refuse to run without a GPU and print no result.
"""
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jex_core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLOAT = (np.dtype(np.float32), np.dtype(np.complex64))
# Contractions allowed below HIGHEST, with the reason:
#   tonal.block_quant: a word length (integer <= 7) times a one-hot; small
#   integers are exact in TF32
_ALLOWED = {("tonal.py", "block_quant")}


def _contractions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            yield eqn
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                if isinstance(sub, jex_core.ClosedJaxpr):
                    yield from _contractions(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    yield from _contractions(sub)


def _unpinned(closed):
    from jax._src import source_info_util

    bad = []
    for eqn in _contractions(closed.jaxpr):
        if not any(v.aval.dtype in _FLOAT for v in eqn.invars):
            continue
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, (tuple, list)) else (prec,)
        if all(p == jax.lax.Precision.HIGHEST for p in precs):
            continue
        frame = source_info_util.user_frame(eqn.source_info.traceback)
        where = (os.path.basename(frame.file_name), frame.function_name) \
            if frame else ("?", "?")
        if where not in _ALLOWED:
            bad.append(f"{eqn.primitive.name} {prec} at {where}")
    return bad


def _at1_encode():
    from atracdenc_tpu.models.atrac1.encoder import encode_frames
    return jax.make_jaxpr(encode_frames)(jnp.zeros((2, 512 * 4)))


def _at3_encode():
    from atracdenc_tpu.models.atrac3.encoder import encode_frames_bytes
    return jax.make_jaxpr(lambda p: encode_frames_bytes(
        p, frame_bytes=384, no_gain_control=False, no_tonal=False))(
            jnp.zeros((2, 1024 * 4)))


def _at3p_encode():
    from atracdenc_tpu.models.atrac3p.encoder import encode_frames_bytes
    return jax.make_jaxpr(lambda p: encode_frames_bytes(p, 2, gha_mask=7))(
        jnp.zeros((2, 2048 * 4)))


def _at1_decode():
    from atracdenc_tpu.models.atrac1.decoder import decode_frames
    c, f = 2, 4
    return jax.make_jaxpr(decode_frames)(
        jnp.zeros((c, f, 3), bool), jnp.zeros((c, f, 52), jnp.int32),
        jnp.zeros((c, f, 52), jnp.int32), jnp.zeros((c, f, 52, 20),
                                                     jnp.int32))


@pytest.mark.parametrize("trace", [_at1_encode, _at3_encode, _at3p_encode,
                                   _at1_decode],
                         ids=["at1_encode", "at3_encode", "at3p_encode",
                              "at1_decode"])
def test_float_contractions_pin_highest(trace):
    closed = trace()
    assert list(_contractions(closed.jaxpr)), "no contraction found"
    bad = _unpinned(closed)
    assert not bad, "\n".join(bad)


def _tracked_py():
    for top in ("atracdenc_tpu", "tools"):
        for d, _, files in os.walk(os.path.join(ROOT, top)):
            yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    yield from (os.path.join(ROOT, f) for f in os.listdir(ROOT)
                if f.endswith(".py"))


def test_no_tpu_only_code():
    tpu = "tp" + "u"
    pats = [re.compile(p) for p in (
        r"pallas\." + tpu, "pl" + tpu, r"[!=]=\s*['\"]" + tpu + "['\"]",
        r"['\"]" + tpu + r"['\"]\s*[!=]=", "ATRACDENC_" + tpu.upper() + "_PALLAS",
        r"interpret\s*=\s*True")]
    bad = []
    for path in _tracked_py():
        with open(path) as f:
            text = f.read()
        bad += [f"{os.path.relpath(path, ROOT)}: {p.pattern}"
                for p in pats if p.search(text)]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, monkeypatch, tmp_path):
    from atracdenc_tpu.utils import compile_cache as CC

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert CC.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = CC.enable_compile_cache()
            assert path == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script,alone", [("chip_smoke.py", False),
                                          ("chip_smoke.py", True),
                                          ("bench.py", False)])
def test_gpu_scripts_refuse_without_gpu(script, alone, tmp_path):
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, script), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert not r.stdout.strip() or "{" not in r.stdout.strip().splitlines()[-1]
