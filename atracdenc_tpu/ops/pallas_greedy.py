"""Pallas kernel (Triton route): the EA greedy-accept scan over sorted
candidates.

The energy-adjusted rounding pass (reference QuantMantisas,
src/atrac/atrac_scale.cpp:85-130) walks borderline values in
|delta|-ascending order, flipping a rounding whenever that moves the
quantized block energy toward the original energy.  Rows are independent;
within a row each step depends on the previous one.

One program owns a power-of-two block of rows and keeps their running
energy in registers across an in-kernel loop over the L steps.  Inputs
arrive pre-sorted (the sort stays in XLA) and transposed to [L, rows], so
step k is one coalesced load of row k per operand; the tail block is
masked.

Float op order matches ops/quant.greedy_scan_xla exactly:
ex = (e2 - a) + b;  accept = elig & (|ex - e1| < |e2 - e1|).  There is no
multiply, so no FMA contraction can change a bit.
"""
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_BLOCK_ROWS = 128


def _kernel(a_ref, b_ref, elig_ref, e1_ref, e2_ref, e2o_ref, acc_ref):
    L, R = a_ref.shape
    rows = pl.program_id(0) * _BLOCK_ROWS + jnp.arange(_BLOCK_ROWS)
    mask = rows < R
    e1 = plt.load(e1_ref.at[rows], mask=mask, other=0.0)

    def step(k, e2):
        ak = plt.load(a_ref.at[k, rows], mask=mask, other=0.0)
        bk = plt.load(b_ref.at[k, rows], mask=mask, other=0.0)
        el = plt.load(elig_ref.at[k, rows], mask=mask, other=0) > 0
        ex = (e2 - ak) + bk
        acc = el & (jnp.abs(ex - e1) < jnp.abs(e2 - e1))
        plt.store(acc_ref.at[k, rows], acc.astype(jnp.int32), mask=mask)
        return jnp.where(acc, ex, e2)

    e2 = plt.load(e2_ref.at[rows], mask=mask, other=0.0)
    e2 = jax.lax.fori_loop(0, L, step, e2)
    plt.store(e2o_ref.at[rows], e2, mask=mask)


@functools.partial(jax.jit, static_argnames=("interpret",))
def greedy_scan(a, b, elig, e1, e2, interpret=False):
    """Run the EA greedy-accept recurrence over sorted candidates.

    a, b:  [rows, L] f32 — the e2-update terms (m^2*inv2, m'^2*inv2) in
           |delta|-rank order;
    elig:  [rows, L] bool — candidate eligibility in the same order;
    e1:    [rows] f32 — target block energy;
    e2:    [rows] f32 — initial quantized energy.

    Returns (e2_fin [rows] f32, accept [rows, L] bool), bit-identical to
    ops/quant.greedy_scan_xla.  `interpret` is for tests on the CPU.
    """
    rows, L = a.shape
    e2f, acc = pl.pallas_call(
        _kernel,
        grid=(pl.cdiv(rows, _BLOCK_ROWS),),
        out_shape=(jax.ShapeDtypeStruct((rows,), jnp.float32),
                   jax.ShapeDtypeStruct((L, rows), jnp.int32)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ea_greedy_scan",
    )(a.T, b.T, elig.T.astype(jnp.int32), e1, e2)
    return e2f, acc.T > 0
