"""Mantissa quantization with optional energy-adjusted rounding ("EA").

Batched reformulation of the reference QuantMantisas (reference:
src/atrac/atrac_scale.cpp:40-130): round-half-even quantization plus, in EA
mode, a greedy pass over borderline values (|frac - 0.5| < 0.25) sorted by
distance to the rounding boundary, flipping individual roundings while that
moves the quantized block energy toward the original energy.

The greedy pass is a true sequential dependence (each accepted flip changes
the running energy), so it runs as a fully-unrolled `lax.scan` over the
rank-ordered candidate axis with the running energy as carry — one fused
scan for every (channel, frame, bfu, wordlen) lane at once.  Candidate
ordering is a stable multi-operand `lax.sort` by |delta| (ties broken by
element index; the reference's std::sort is unstable, so tie order is
unspecified there); integer side-operands sort exactly, so no float
round-trip touches the greedy inputs.
"""
import jax
import jax.numpy as jnp

__all__ = ["quant_blocks", "greedy_scan_xla"]


def greedy_scan_xla(a, b, elig, e1, e2):
    """The EA greedy-accept recurrence as a fully unrolled `lax.scan`.

    a, b, elig: [rows, L] in |delta|-rank order; e1, e2: [rows].
    Returns (e2_fin [rows], accept [rows, L] bool).  L is static (<= 128)
    and the body is ~6 elementwise ops on [rows]; a rolled loop makes each
    step its own kernel launch with a round trip of the carry to memory.
    """
    def step(e2_run, xs):
        elig_k, a_k, b_k = xs
        ex = (e2_run - a_k) + b_k
        accept = elig_k & (jnp.abs(ex - e1) < jnp.abs(e2_run - e1))
        return jnp.where(accept, ex, e2_run), accept

    e2_fin, accept = jax.lax.scan(
        step, e2, (jnp.moveaxis(elig, -1, 0), jnp.moveaxis(a, -1, 0),
                   jnp.moveaxis(b, -1, 0)), unroll=True)
    return e2_fin, jnp.moveaxis(accept, 0, -1)


def _greedy(a, b, elig, e1, e2):
    """On the GPU the recurrence runs as the Triton kernel
    (ops/pallas_greedy.py); elsewhere as the XLA scan.  Both apply the
    identical float ops in the identical order."""
    if jax.default_backend() == "gpu":
        from atracdenc_tpu.ops.pallas_greedy import greedy_scan
        return greedy_scan(a, b, elig, e1, e2)
    return greedy_scan_xla(a, b, elig, e1, e2)


def _round_energy(scaled, valid, mul):
    """Plain ToInt quantization + energies.

    scaled: [..., L]; valid: [..., L] bool; mul: scalar or [...] multiplier.
    Returns (mant int32 [..., L], e1 [...], e2 [...]).
    """
    t = scaled * mul[..., None]
    mant = jnp.round(t).astype(jnp.int32)
    mant = jnp.where(valid, mant, 0)
    inv2 = 1.0 / (mul * mul)
    e1 = jnp.sum(jnp.where(valid, scaled * scaled, 0.0), axis=-1)
    m2 = (mant * mant).astype(scaled.dtype)
    e2 = jnp.sum(jnp.where(valid, m2, 0.0), axis=-1) * inv2
    return mant, e1, e2


def quant_blocks(scaled, valid, mul, ea_mask, aux=None):
    """Quantize padded blocks at a given multiplier, with EA where masked.

    scaled:  [..., L] block values in (-1, 1) (padding must be 0)
    valid:   [..., L] bool
    mul:     [...] float multiplier (MaxQuant[wordlen]); 0 -> all-zero output
    ea_mask: [...] bool — lanes using energy-adjusted rounding
    aux:     optional [..., L] int32 per-candidate weights (e.g. VLC bit
             deltas of a flip).  When given, the function runs in COST mode:
             it skips materializing the adjusted mantissas (and the inverse
             permutation) and returns (err [...], aux_sum [...]) where
             aux_sum accumulates aux over accepted flips.

    Without aux, returns (mant [..., L] int32, err [...]) where err = e1/e2
    evaluated in float32 exactly like the reference (inf/nan propagate the
    same way).
    """
    t = scaled * mul[..., None]
    mant0, e1, e2 = _round_energy(scaled, valid, mul)
    inv2 = jnp.where(mul > 0, 1.0 / (mul * mul), 0.0)

    # EA candidates: |t - (trunc(t) + 0.5)| < 0.25 (atrac_scale.cpp:66-73)
    delta = t - (jnp.trunc(t) + 0.5)
    cand = valid & (jnp.abs(delta) < 0.25) & ea_mask[..., None] & (mul > 0)[..., None]

    # rank/gather run on 2-D [rows, L] layouts (high-rank shapes with a
    # small trailing dim lowered to far slower sorts and gathers)
    batch_shape = scaled.shape[:-1]
    L = scaled.shape[-1]
    flat = lambda x: x.reshape((-1, L))
    t = flat(t)
    mant = flat(mant0)
    cand = flat(cand)
    e1f = e1.reshape(-1)
    e2f = e2.reshape(-1)
    mulf = mul.reshape(-1)
    inv2f = inv2.reshape(-1)
    abs_t = jnp.abs(t)
    abs_m = jnp.abs(mant).astype(scaled.dtype)

    up = e2f < e1f  # branch fixed before the pass (atrac_scale.cpp:85,107)
    dn = e2f > e1f

    # Proposed flipped mantissa per candidate (away from 0 when up-branch,
    # toward 0 when down-branch) and its eligibility — all per element,
    # BEFORE ordering (they don't depend on the greedy state).
    m_up = jnp.where(mant > 0, mant + 1, jnp.where(mant < 0, mant - 1,
                     jnp.where(t > 0, 1, -1)))
    m_dn = jnp.where(mant > 0, mant - 1, jnp.where(mant < 0, mant + 1, mant))
    m_new = jnp.where(up[..., None], m_up, m_dn)
    elig_up = (abs_m < abs_t) & (abs_m < (mulf - 1.0)[..., None])
    elig_dn = abs_m > abs_t
    elig = cand & jnp.where(up[..., None], elig_up,
                            jnp.where(dn[..., None], elig_dn, False))

    # Candidates process in |delta|-ascending order.  A stable lax.sort
    # carries the greedy inputs into rank order exactly — ints sort
    # losslessly, stability reproduces the former comparison-count rank's
    # index tie-break.  The sort's data movement dominates the EA pass,
    # so every integer side-input (mantissa, eligibility, sign of t, VLC
    # bit delta) packs into ONE int32 operand;
    # the float a/b energy terms are recomputed from the exact integer
    # mantissas after the sort (bit-identical: same ints, same ops).
    key = jnp.where(cand, jnp.abs(flat(delta)), jnp.inf)
    auxf = flat(aux) if aux is not None else jnp.zeros_like(mant)
    packed = (((mant + 128) << 13) | ((auxf + 1024) << 2)
              | (elig.astype(jnp.int32) << 1) | (t > 0).astype(jnp.int32))
    if aux is not None:
        sorted_ops = jax.lax.sort([key, packed], dimension=-1, num_keys=1,
                                  is_stable=True)
        packed_s = sorted_ops[1]
        idx_s = None
    else:
        li = jnp.arange(L, dtype=jnp.int32)
        iota = jnp.broadcast_to(li, key.shape)
        sorted_ops = jax.lax.sort([key, iota, packed], dimension=-1,
                                  num_keys=1, is_stable=True)
        idx_s, packed_s = sorted_ops[1], sorted_ops[2]
    m_s = (packed_s >> 13) - 128
    aux_s = ((packed_s >> 2) & 0x7FF) - 1024
    elig_s = ((packed_s >> 1) & 1) > 0
    tpos_s = (packed_s & 1) > 0
    mn_up = jnp.where(m_s > 0, m_s + 1,
                      jnp.where(m_s < 0, m_s - 1,
                                jnp.where(tpos_s, 1, -1)))
    mn_dn = jnp.where(m_s > 0, m_s - 1, jnp.where(m_s < 0, m_s + 1, m_s))
    mn_s = jnp.where(up[..., None], mn_up, mn_dn)
    a = (m_s * m_s).astype(scaled.dtype) * inv2f[..., None]
    b = (mn_s * mn_s).astype(scaled.dtype) * inv2f[..., None]

    # e2 update terms, applied in the reference's exact float order:
    # ex = (e2 - m^2*inv2) + m'^2*inv2 (atrac_scale.cpp:96-98,118-121)
    e2_fin, accept_s = _greedy(a, b, elig_s, e1f, e2f)
    err = (e1f / e2_fin).reshape(batch_shape)

    if aux is not None:
        # cost mode: no mantissas, no unsorting — only the sum of aux over
        # accepted flips
        aux_sum = jnp.sum(jnp.where(accept_s, aux_s, 0), axis=-1)
        return err, aux_sum.astype(jnp.int32).reshape(batch_shape)

    # unsort `accept` by a second stable sort keyed on the carried indices
    _, accept_i = jax.lax.sort((idx_s, accept_s.astype(jnp.int32)),
                               dimension=-1, num_keys=1, is_stable=True)
    mant = jnp.where(accept_i > 0, m_new, mant)
    mant = mant.reshape(batch_shape + (L,))
    return jnp.where(valid, mant, 0), err
