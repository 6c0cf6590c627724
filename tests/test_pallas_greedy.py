"""The EA greedy-accept recurrence: ops/pallas_greedy.greedy_scan (Triton
route, interpret mode here) and ops/quant.greedy_scan_xla against a NumPy
loop of the reference's float32 arithmetic (atrac_scale.cpp:85-130)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.ops.pallas_greedy import greedy_scan
from atracdenc_tpu.ops.quant import greedy_scan_xla


def _numpy_loop(a, b, elig, e1, e2):
    f32 = np.float32
    rows, L = a.shape
    e2 = np.array(e2, f32)
    acc = np.zeros((rows, L), bool)
    for r in range(rows):
        for k in range(L):
            ex = f32(f32(e2[r] - a[r, k]) + b[r, k])
            if elig[r, k] and abs(f32(ex - e1[r])) < abs(f32(e2[r] - e1[r])):
                e2[r] = ex
                acc[r, k] = True
    return e2, acc


def _case(rows, L, seed):
    rng = np.random.default_rng(seed)
    # realistic magnitudes: a/b are m^2*inv2 with |m| <= 32
    m = rng.integers(-32, 33, (rows, L))
    mn = m + np.where(m >= 0, 1, -1)
    inv2 = rng.random((rows, 1)).astype(np.float32) + 0.01
    a = (m * m).astype(np.float32) * inv2
    b = (mn * mn).astype(np.float32) * inv2
    elig = rng.random((rows, L)) < 0.4
    e1 = rng.random(rows).astype(np.float32) * 50.0
    e2 = rng.random(rows).astype(np.float32) * 50.0
    return a, b, elig, e1, e2


@pytest.mark.parametrize("rows,L", [(7, 32), (33, 64), (130, 128)])
def test_greedy_scan_matches_unrolled_scan(rows, L):
    args = _case(rows, L, rows * L)
    e2_np, acc_np = _numpy_loop(*args)
    jargs = [jnp.asarray(x) for x in args]
    e2_x, acc_x = jax.jit(greedy_scan_xla)(*jargs)
    e2_k, acc_k = greedy_scan(*jargs, interpret=True)
    assert np.array_equal(e2_np, np.asarray(e2_x))
    assert np.array_equal(acc_np, np.asarray(acc_x))
    assert np.array_equal(np.asarray(e2_x), np.asarray(e2_k))
    assert np.array_equal(np.asarray(acc_x), np.asarray(acc_k))


def test_greedy_scan_masked_tail():
    """A row count one past a whole block: the last program's lanes beyond
    the rows are masked and must not disturb the real rows; rows with no
    eligible candidate keep their energy."""
    rows, L = 129, 32
    a, b, elig, e1, e2 = _case(rows, L, 5)
    elig[-1] = False
    e2_np, acc_np = _numpy_loop(a, b, elig, e1, e2)
    e2_k, acc_k = greedy_scan(*[jnp.asarray(x) for x in (a, b, elig, e1, e2)],
                              interpret=True)
    assert np.asarray(e2_k).shape == (rows,)
    assert np.array_equal(e2_np, np.asarray(e2_k))
    assert np.array_equal(acc_np, np.asarray(acc_k))
    assert np.asarray(e2_k)[-1] == e2[-1] and not np.asarray(acc_k)[-1].any()
