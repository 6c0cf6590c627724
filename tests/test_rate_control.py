"""Rate control (AT3 and AT1 bitalloc.allocate) against the reference-float
allocators of exact_enc, channel-frame by channel-frame: the same
CalcBitsAllocation, ConsiderEnergyErr boost, spec-bit costing, tonal
dry-run cost, lambda bisection and BFU shrink, on the same inputs, must
give the same num_bfu / bfu_idx, coding mode and word lengths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3 import bitalloc, exact_enc, tables as T, tonal
from atracdenc_tpu.models.atrac3.encoder import _GATHER_MASK, gather_bfu_blocks
from atracdenc_tpu.ops import scale as scale_ops

_PLANE_KEYS = ("active", "start", "len", "bfu", "vlc_cost")


@jax.jit
def _tonal_cost(planes, wl, num_bfu):
    return tonal.make_cost_fn(planes)(wl, num_bfu)


def _random_case(seed, c=2, f=6, with_tonal=True):
    rng = np.random.default_rng(seed)
    specs = (rng.standard_normal((c, f, 1024))
             * 10.0 ** rng.uniform(-4, 0, (c, f, 1))).astype(np.float32)
    specs = jnp.asarray(specs)
    if with_tonal:
        flat = tonal.flatness_per_bfu(specs * specs)
        specs2, tp = tonal.extract(specs, flat)
        planes = tonal.scale_groups(tp)
    else:
        specs2, planes = specs, None
    blocks = gather_bfu_blocks(specs2)
    sfi, scaled, energy = scale_ops.scale_blocks(
        blocks, _GATHER_MASK, jnp.asarray(T.SCALE_TABLE))
    gsf = (10.0 ** rng.uniform(-0.3, 0.3, (c, f, 4))).astype(np.float32)
    loud = (10.0 ** rng.uniform(-3, 0, (c, f))).astype(np.float32)
    target = rng.integers(300, 1600, (c, f)).astype(np.int32)
    return {"sfi": np.asarray(sfi), "scaled": np.asarray(scaled),
            "energy": np.asarray(energy), "gsf": gsf, "loud": loud,
            "target": target, "planes": planes}


def _counts(planes):
    return jnp.asarray((np.eye(32, dtype=np.int32)[np.asarray(planes["bfu"])]
                        * np.asarray(planes["active"])[..., None]).sum(-2))


def _spread(sfi):
    return np.vectorize(lambda i: exact_enc._spread(sfi.reshape(-1, 32)[i]),
                        otypes=[np.float32])(np.arange(sfi.size // 32)
                                             ).reshape(sfi.shape[:-1])


def _allocate_xla(case):
    qt = bitalloc.quant_tensors(jnp.asarray(case["scaled"]), _GATHER_MASK)
    planes = case["planes"]
    kw = {}
    if planes is not None:
        kw = dict(tonal_counts=_counts(planes),
                  tonal_bits_fn=tonal.make_cost_fn(planes))
    nb, mode, wl = bitalloc.allocate(
        qt, jnp.asarray(case["sfi"]), jnp.asarray(case["gsf"]),
        jnp.asarray(case["energy"]), jnp.asarray(_spread(case["sfi"])),
        jnp.asarray(case["loud"]), jnp.asarray(case["target"]), **kw)
    return np.asarray(nb), np.asarray(mode), np.asarray(wl)


def _allocate_oracle(case, ch, fr):
    sfi = case["sfi"][ch, fr]
    vals = [case["scaled"][ch, fr, b, :int(T.SPECS_PER_BLOCK[b])]
            for b in range(32)]
    planes = case["planes"]
    tonal_bfus, cost_fn = (), None
    if planes is not None:
        one = {k: jnp.asarray(np.asarray(planes[k])[ch, fr])
               for k in _PLANE_KEYS}
        act = np.asarray(planes["active"])[ch, fr]
        tonal_bfus = [int(b) for b in np.asarray(planes["bfu"])[ch, fr][act]]

        def cost_fn(alloc):
            wl = np.zeros(32, np.int32)
            wl[:len(alloc)] = alloc
            return int(_tonal_cost(one, jnp.asarray(wl),
                                   jnp.asarray(len(alloc), jnp.int32)))
    nb, mode, wl, _ = exact_enc._allocate_channel(
        sfi, vals, case["energy"][ch, fr], int(case["target"][ch, fr]),
        case["loud"][ch, fr], case["gsf"][ch, fr], tonal_bfus=tonal_bfus,
        tonal_cost_fn=cost_fn)
    return nb, mode, wl


def _assert_matches_oracle(case, got):
    nb, mode, wl = got
    c, f = case["sfi"].shape[:2]
    for ch in range(c):
        for fr in range(f):
            onb, omode, owl = _allocate_oracle(case, ch, fr)
            where = (ch, fr)
            assert nb[ch, fr] == onb, where
            assert np.array_equal(wl[ch, fr], owl), where
            assert bool(mode[ch, fr]) == bool(omode), where


@pytest.mark.parametrize("with_tonal", [False, True])
def test_allocate_matches_reference_allocator(with_tonal):
    for seed in (0, 1):
        case = _random_case(seed, with_tonal=with_tonal)
        _assert_matches_oracle(case, _allocate_xla(case))


def test_allocate_under_vmap():
    """The batch transcoder vmaps the encoder over streams: the vmapped
    allocation equals the unbatched one and the oracle."""
    cases = [_random_case(s, c=1, f=4, with_tonal=False) for s in (0, 1)]
    stack = lambda k: jnp.asarray(np.stack([c[k] for c in cases]))
    qt = jax.vmap(lambda s: bitalloc.quant_tensors(s, _GATHER_MASK))(
        stack("scaled"))
    spread = jnp.asarray(np.stack([_spread(c["sfi"]) for c in cases]))
    nb, mode, wl = jax.vmap(bitalloc.allocate)(
        qt, stack("sfi"), stack("gsf"), stack("energy"), spread,
        stack("loud"), stack("target"))
    for i, case in enumerate(cases):
        got = (np.asarray(nb[i]), np.asarray(mode[i]), np.asarray(wl[i]))
        one = _allocate_xla(case)
        for a, b in zip(got, one):
            assert np.array_equal(a, b)
        _assert_matches_oracle(case, got)


@pytest.mark.parametrize("const", [0, 1, 4])
def test_at1_allocate_matches_reference_allocator(const):
    """ATRAC1 rate control (bisect + BFU-table shrink + booster)."""
    from atracdenc_tpu.models.atrac1 import bitalloc as ba1
    from atracdenc_tpu.models.atrac1 import exact_enc as ex1

    rng = np.random.default_rng(3)
    c, f = 2, 8
    sfi = rng.integers(0, 64, (c, f, 52)).astype(np.int32)
    energy = (10.0 ** rng.uniform(-9, 2, (c, f, 52))).astype(np.float32)
    short = rng.integers(0, 2, (c, f, 3)) > 0
    loud = (10.0 ** rng.uniform(-4, 0, (c, f))).astype(np.float32)
    idx, wl = ba1.allocate(jnp.asarray(sfi), jnp.asarray(energy),
                           jnp.asarray(short), jnp.asarray(loud),
                           bfu_idx_const=const)
    idx, wl = np.asarray(idx), np.asarray(wl)
    for ch in range(c):
        for fr in range(f):
            oidx, owl = ex1._allocate_channel(
                sfi[ch, fr], energy[ch, fr], short[ch, fr], loud[ch, fr],
                bfu_idx_const=const)
            assert idx[ch, fr] == oidx, (ch, fr)
            assert np.array_equal(wl[ch, fr], owl), (ch, fr)


def test_allocate_dense_tonal_limiter_breaks():
    """Dense same-bucket tonal planes (>= 8 blocks in one 64-line anchor
    group) reach the subgroup limiter's break ranks (cnt == 8, 15), which
    randomly extracted planes almost never do."""
    case = _random_case(11, with_tonal=False)
    c, f = case["sfi"].shape[:2]
    rng = np.random.default_rng(11)
    nb = 32
    k = 18                       # one bucket, one 64-group: ranks 8 and 15
    act = np.zeros((c, f, nb), bool)
    start = np.zeros((c, f, nb), np.int32)
    ln = np.zeros((c, f, nb), np.int32)
    bfu = np.zeros((c, f, nb), np.int32)
    act[..., :k] = True
    start[..., :k] = 256 + np.arange(k) * 3   # all inside pos>>6 == 4
    ln[..., :k] = 2
    bfu[..., :k] = 10                         # same wl -> same quant bucket
    case["planes"] = {
        "active": jnp.asarray(act), "start": jnp.asarray(start),
        "len": jnp.asarray(ln), "bfu": jnp.asarray(bfu),
        "vlc_cost": jnp.asarray(
            rng.integers(4, 60, size=(c, f, nb, 8)).astype(np.int32)),
    }
    _assert_matches_oracle(case, _allocate_xla(case))


def test_allocate_low_budget_shrink():
    """Tiny targets exercise the num_bfu clamp + shrink Repeat rounds."""
    case = _random_case(7, with_tonal=True)
    case["target"] = np.random.default_rng(7).integers(
        40, 220, case["target"].shape).astype(np.int32)
    got = _allocate_xla(case)
    assert (got[0] < 32).any()
    _assert_matches_oracle(case, got)
