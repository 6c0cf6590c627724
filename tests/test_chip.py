"""What only the card can show: the Triton kernel compiled by the GPU
toolchain at real widths, and the golden byte floors of the fast path
under the GPU's numerics (cuFFT, reduction order).  Skips without a GPU;
run with  JAX_PLATFORMS=cuda python -m pytest -m chip tests/"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import golden_check  # noqa: E402

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("rows,L", [(32768 * 7 * 6, 32), (32768 * 4 * 6, 64),
                                    (32768 * 2 * 6 + 37, 128)])
def test_greedy_kernel_compiled_equals_xla(chip, rows, L):
    from atracdenc_tpu.ops.pallas_greedy import greedy_scan
    from atracdenc_tpu.ops.quant import greedy_scan_xla

    rng = np.random.default_rng(rows)
    m = rng.integers(-32, 33, (rows, L))
    mn = m + np.where(m >= 0, 1, -1)
    inv2 = (rng.random((rows, 1)) + 0.01).astype(np.float32)
    args = (jnp.asarray((m * m).astype(np.float32) * inv2),
            jnp.asarray((mn * mn).astype(np.float32) * inv2),
            jnp.asarray(rng.random((rows, L)) < 0.4),
            jnp.asarray(rng.random(rows).astype(np.float32) * 50.0),
            jnp.asarray(rng.random(rows).astype(np.float32) * 50.0))
    for a, b in zip(greedy_scan(*args), jax.jit(greedy_scan_xla)(*args)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", golden_check.CASES, ids=lambda c: c[0])
def test_at3_golden_floor(chip, case):
    r = golden_check.at3_case(*case)
    assert r["ok"], f"{case[0]}: identity {r['identity']:.4f} <= {case[-1]}"


@pytest.mark.parametrize("npz,ref", golden_check.AT1_CASES)
def test_at1_golden_floor(chip, npz, ref):
    r = golden_check.at1_case(npz, ref)
    assert r["ok"], r


def test_at1_decode_bound(chip):
    r = golden_check.at1_decode_case()
    assert r["ok"], r


@pytest.mark.parametrize("pk,rk", golden_check.AT3P_CASES)
def test_at3p_golden_floor(chip, pk, rk):
    r = golden_check.at3p_case(pk, rk)
    assert r["ok"], r
