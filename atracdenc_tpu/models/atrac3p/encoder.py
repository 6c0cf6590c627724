"""ATRAC3+ encoder: whole-track, batched.

Pipeline (reference: src/atrac/at3p/at3p.cpp:89-180):
  16-band PQF analysis -> [GHA tonal model] -> one-frame-delayed residual,
  scaled by 1/(32768/1.122018) -> per-subband MDCT -> block-floating scale ->
  fixed per-QU wordlens -> mantissa quantization -> best-of-8 spectrum VLC
  table per quant unit -> NumQuantUnits shrink until the 2048-byte frame fits.

The reference's one-frame look-ahead (LOOK_AHEAD + drain) makes the first
output frame silent and drops the final content frame; the whole-track form
reproduces that by shifting the residual stream one frame right.

The GHA tonal model is staged separately; without it the residual equals the
PQF output (equivalent to a GHA pass that detects no tones), which is a
complete, valid ATRAC3+ stream.
"""
from functools import partial

import jax
import jax.numpy as jnp
from atracdenc_tpu.utils.npconst import _npc
import numpy as np

from atracdenc_tpu.ops import scale as scale_ops
from . import tables as T
from . import pqf
from . import gha
from .mdct import mdct_frames

_GATHER_MASK = _npc(np.asarray(T.GATHER_MASK))
_SCALE_TABLE = _npc(np.asarray(T.SCALE_TABLE))


def band_frames(pcm):
    """[C, T] PCM -> [C, F, 16, 128] PQF band samples."""
    c, t = pcm.shape
    f = t // T.NUM_SAMPLES
    bands = pqf.analysis(pcm)                 # [C, 16, T/16]
    return jnp.swapaxes(bands.reshape(c, 16, f, 128), 1, 2)


def gather_qu_blocks(specs):
    """[..., 2048] spectra -> padded QU blocks [..., 32, 128].

    The QUs tile the spectrum with contiguous ranges (BLOCK_SIZE_TAB,
    at3p_tables.h:58-76), so this is a static slice/pad composition — NOT
    a gather: static slices compile to plain copies, same as
    models/atrac3/specblocks.py."""
    parts = []
    for b in range(32):
        s = int(T.SPECS_START[b])
        ln = int(T.SPECS_PER_BLOCK[b])
        parts.append(jnp.pad(specs[..., s:s + ln],
                             [(0, 0)] * (specs.ndim - 1) + [(0, 128 - ln)]))
    return jnp.stack(parts, axis=-2)


def _qu_table_cost(mant, qu, tab_idx):
    """Spectrum bits for one QU at one table (EncodeQuSpectra dry run,
    at3p_bitstream.cpp:286-345). mant: [..., L]."""
    gs, nc, bits, signed = (int(x) for x in T.SPECTRA_TABS[tab_idx])
    ln = int(T.SPECS_PER_BLOCK[qu])
    m = mant[..., :ln]
    ncodes = ln // nc
    grp = m.reshape(m.shape[:-1] + (ncodes, nc))
    if signed:
        t = grp & ((1 << bits) - 1)
        sign_bits = 0
    else:
        t = jnp.abs(grp)
        sign_bits = jnp.sum((grp != 0).astype(jnp.int32), axis=(-1, -2))
    shifts = (bits * np.arange(nc)).astype(np.int32)
    val = jnp.sum(t << shifts, axis=-1)       # [..., ncodes]
    # len[val] as a fused equality-sum over the (<=256-entry) codebook row
    # instead of a per-element dynamic gather
    nsyms = 1 << (bits * nc)
    lens = jnp.asarray(T.SPEC_LEN[tab_idx, :nsyms])
    code_bits = jnp.sum(
        jnp.sum(jnp.where(val[..., None] == jnp.arange(nsyms), lens, 0),
                axis=-1), axis=-1)
    group_bits = 0 if gs == 1 else ncodes // gs
    return code_bits + sign_bits + group_bits


def _wordlen_section_bits():
    """([33], [33]) ch0/ch1 wordlen-section bits per numQU, summed from
    the PACKER's own field widths so the numQU-shrink budget can never
    drift from what frame.pack actually writes (the wordlens are the
    fixed table, so the cost is constant per numQU; TWordLenEncoder,
    at3p_bitstream.cpp:156-247)."""
    from . import frame as fr
    ch0 = np.zeros(33, np.int64)
    ch1 = np.zeros(33, np.int64)
    for nq in range(1, 33):
        ch0[nq] = sum(w for _, w in fr._wl_fields(nq))
        ch1[nq] = sum(w for _, w in fr._wl_fields_ch1(nq))
    return ch0, ch1


_WL_BITS_CH0, _WL_BITS_CH1 = _wordlen_section_bits()


def _const_bits(channels):
    """[33] per-numQU section bits that don't depend on the spectra."""
    nq = np.arange(33)
    bits = np.zeros(33, np.int64)
    bits += 5 + 1                                   # TConfigure
    bits += _WL_BITS_CH0
    if channels == 2:
        bits += _WL_BITS_CH1
    bits += channels * (2 + 6 * nq)                 # TSfIdx
    bits += 1 + channels * (1 + 2 + 1 + 3 * nq)     # EncodeCodeTab (full table)
    pwr = T.SUBBAND_TO_NUM_POWGRPS[T.QU_TO_SUBBAND[np.maximum(nq, 1) - 1]]
    bits += channels * 4 * pwr                      # power-comp stubs
    if channels == 2:
        bits += 2                                   # swap/negate flags
    bits += channels * 1                            # window shape (all sine)
    bits += channels * 1                            # gain comp
    bits += 1                                       # no tonal block
    bits += 1 + 2                                   # no noise + terminator
    return bits


def _core_impl(pcm, gha_mask, wb_refine, left, right, zero_tail,
               with_history):
    """Shared encode core over an (optionally) extended frame window.

    left/right = 0, with_history = False: the whole-track path (bit-for-bit
    the original formulation).  left >= 2, right == 1, with_history = True:
    a chunk window — pcm = [OVERLAP PQF history | left context frames |
    f content frames | 1 lookahead frame]; every cross-frame coupling
    (PQF FIR memory, GHA envelope chaining and next-frame continuation,
    the one-frame residual delay and the MDCT stored half,
    at3p.cpp:89-180) reaches at most 4 frames left / 1 frame right, so the
    sliced content frames are bit-identical to a whole-track run.
    zero_tail (last chunk): the lookahead frame's bands are forced to zero,
    matching the whole-track zero padding past the end of the track."""
    c = pcm.shape[0]
    hist = pqf.OVERLAP if with_history else 0
    t = pcm.shape[1] - hist
    fe = t // T.NUM_SAMPLES                         # left + f + right
    f = fe - left - right

    bands_flat = pqf.analysis(pcm, with_history=with_history)
    bands = jnp.swapaxes(bands_flat.reshape(c, 16, fe, 128), 1, 2)
    if zero_tail and right:
        bands = bands.at[:, fe - 1].set(0.0)        # no frame past track end
    if gha_mask is None:
        resid = bands
        tone_out = None
    else:
        if gha_mask & 8:
            raw = pcm[:, hist:].reshape(c, fe, T.NUM_SAMPLES)
            if zero_tail and right:
                raw = raw.at[:, fe - 1].set(0.0)
            tone_planes = gha.extract_wideband(
                bands, raw, refine_raw=bool(wb_refine))
        else:
            tone_planes = gha.extract(bands)
        src = bands if (gha_mask & 1) else jnp.zeros_like(bands)
        resid = gha.subtract(src, tone_planes)
        if not (gha_mask & 4):
            resid = jnp.zeros_like(resid)
        if gha_mask & 2:
            # output alignment (one-frame tonal-block delay,
            # at3p.cpp:128-131,173-177): out frame p carries tone frame p-1;
            # sharing/leader are per-frame (ax 0)
            tone_out = {}
            for k, v in tone_planes.items():
                ax = 0 if k in ("sharing", "leader") else 1
                if left:
                    sl = [slice(None)] * v.ndim
                    sl[ax] = slice(left - 1, left + f - 1)
                    tone_out[k] = v[tuple(sl)]
                else:
                    pad = [(0, 0)] * v.ndim
                    pad[ax] = (1, 0)
                    tone_out[k] = jnp.pad(v[(slice(None),) * ax
                                            + (slice(None, -1),)], pad)
        else:
            tone_out = None
    # one-frame delay: output frame p carries content frame p-1 (LOOK_AHEAD)
    if left:
        # res window [left-1, left+f) plus one MDCT warm-up frame whose
        # stored half seeds position left-1's overlap; drop its output
        res_win = resid[:, left - 2: left + f - 1]
        specs = mdct_frames(res_win * T.RESIDUAL_SCALE)[:, 1:]
    else:
        res = jnp.pad(resid[:, :-1], ((0, 0), (1, 0), (0, 0), (0, 0)))
        specs = mdct_frames(res * T.RESIDUAL_SCALE)  # [C, F, 2048]

    blocks = gather_qu_blocks(specs)                # [C, F, 32, 128]
    sfi, scaled, _ = scale_ops.scale_blocks(
        blocks, _GATHER_MASK, _SCALE_TABLE)

    inv_mant = jnp.asarray(T.INV_MANT_TAB)[jnp.asarray(T.FIXED_WORDLEN)]
    mant = jnp.round(scaled * inv_mant[:, None]).astype(jnp.int32)
    mant = jnp.where(_GATHER_MASK, mant, 0)

    # best-of-8 spectrum table per QU (strict less -> first minimum)
    costs = []
    for qu in range(32):
        wl = int(T.FIXED_WORDLEN[qu])
        qc = [ _qu_table_cost(mant[..., qu, :], qu, 7 * i + wl - 1)
               for i in range(8) ]
        costs.append(jnp.stack(qc, axis=-1))        # [C, F, 8]
    cost = jnp.stack(costs, axis=-2)                # [C, F, 32, 8]
    spec_tab = jnp.argmin(cost, axis=-1).astype(jnp.int32)
    spec_bits = jnp.min(cost, axis=-1)              # [C, F, 32]

    return sfi, mant, spec_tab, spec_bits, tone_out


@partial(jax.jit, static_argnames=("gha_mask", "wb_refine"))
def _encode_core(pcm, gha_mask=7, wb_refine=None):
    """Whole-track core.  gha_mask: None = GHA disabled (plain transform,
    equivalent to a GHA pass that finds no tones); else the reference's
    --advanced ghadbg bitmask (atrac3p.h:29-43): 1 = GHA_PASS_INPUT (code
    the residual input; clear -> the transform path sees silence), 2 =
    GHA_WRITE_TONAL (tonal block on the wire), 4 = GHA_WRITE_RESIUDAL
    (spectra on the wire), 8 = GHA_WIDEBAND (strategy B; wb_refine: False =
    subband refine, True = raw, per --advanced ghawbrefine).  Default
    GHA_ENABLED = 7."""
    return _core_impl(pcm, gha_mask, wb_refine, 0, 0, False, False)


CHUNK_LEFT = 4      # context frames that pin every cross-frame coupling
CHUNK_RIGHT = 1     # lookahead frames (GHA CheckNextFrame + synth region 2)


@partial(jax.jit, static_argnames=("gha_mask", "wb_refine", "zero_tail"))
def _encode_core_window(pcm_ext, gha_mask=7, wb_refine=None,
                        zero_tail=False):
    """Chunk core: pcm_ext [C, OVERLAP + (CHUNK_LEFT+f+1)*2048] ->
    planes for the f content frames (see _core_impl)."""
    return _core_impl(pcm_ext, gha_mask, wb_refine, CHUNK_LEFT, CHUNK_RIGHT,
                      zero_tail, True)


from functools import lru_cache


@lru_cache(maxsize=None)
def _tonal_bits_fn(channels):
    from .device_pack import tonal_fields_device
    return jax.jit(lambda tt: tonal_fields_device(tt, channels)[3])


def _gha_mask_of(use_gha):
    if use_gha is True:
        return 7
    if use_gha is False:
        return None
    return int(use_gha)


def encode_frames_chunk(pcm, state=None, next_head=None, use_gha=True,
                        wb_refine=False):
    """Exact chunked encode (the AT3P analog of atrac3's
    encode_frames_chunk): pcm [C, k*2048] content samples, state = carry
    from the previous chunk (None at track start), next_head [C, 2048] =
    the next chunk's first frame (None at track end).  Returns
    (planes, state); concatenated chunk planes are bit-identical to
    encode_track on the whole padded track (reference state carries:
    src/atrac/at3p/at3p.cpp:89-180)."""
    pcm = np.asarray(pcm, np.float32)
    c = pcm.shape[0]
    hist_len = pqf.OVERLAP + CHUNK_LEFT * T.NUM_SAMPLES
    hist = (np.zeros((c, hist_len), np.float32) if state is None
            else state["pcm_hist"])
    tail = (np.zeros((c, T.NUM_SAMPLES), np.float32) if next_head is None
            else np.asarray(next_head, np.float32))
    ext = np.concatenate([hist, pcm, tail], axis=1)
    core = _encode_core_window(jnp.asarray(ext),
                               gha_mask=_gha_mask_of(use_gha),
                               wb_refine=wb_refine,
                               zero_tail=next_head is None)
    planes = _finish_planes(core, c)
    new_state = {"pcm_hist": ext[:, pcm.shape[1]: hist_len + pcm.shape[1]]}
    return planes, new_state


def encode_track(pcm: np.ndarray, use_gha=True, wb_refine=False,
                 chunk_frames=512, progress=None):
    """[C, T] PCM -> ATRAC3+ frame planes (dict of numpy arrays).

    use_gha: True -> GHA_ENABLED (mask 7); False -> GHA disabled entirely
    (plain transform); int -> the reference's ghadbg mask (0..15, bit 3 =
    wideband strategy B).  wb_refine selects ghawbrefine=1 (raw).
    Long tracks encode in exact chunks of chunk_frames (bounded device
    memory); progress: optional callback(percent)."""
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    c, t = pcm.shape
    pad = (-t) % T.NUM_SAMPLES
    if pad:
        pcm = np.pad(pcm, ((0, 0), (0, pad)))
    f_total = pcm.shape[1] // T.NUM_SAMPLES

    if chunk_frames and f_total > chunk_frames:
        state = None
        outs = []
        ns = T.NUM_SAMPLES
        for a in range(0, f_total, chunk_frames):
            b = min(a + chunk_frames, f_total)
            nxt = pcm[:, b * ns: (b + 1) * ns] if b < f_total else None
            planes, state = encode_frames_chunk(
                pcm[:, a * ns: b * ns], state, nxt, use_gha, wb_refine)
            outs.append(planes)
            if progress is not None:
                progress(int(b * 100 / f_total))
        merged = {}
        for k in outs[0]:
            if k == "tones":
                merged[k] = {tk: np.concatenate(
                    [o[k][tk] for o in outs],
                    axis=0 if tk in ("sharing", "leader") else 1)
                    for tk in outs[0][k]}
            else:
                # num_qu is [F]; sfi/mant/spec_tab are [C, F, ...]
                merged[k] = np.concatenate([o[k] for o in outs],
                                           axis=0 if k == "num_qu" else 1)
        return merged

    core = _encode_core(jnp.asarray(pcm), gha_mask=_gha_mask_of(use_gha),
                        wb_refine=wb_refine)
    out = _finish_planes(core, c)
    if progress is not None:
        progress(100)
    return out


def _finish_planes_device(core, c):
    """Device counterpart of _finish_planes: tone wire ordering, tonal
    section budget, and the NumQuantUnits shrink as one-hot selects — no
    host round trip (the round-3 AT3P production path paid a numpy walk
    per chunk here, VERDICT r3 #2)."""
    from .device_pack import tonal_fields_device
    sfi, mant, spec_tab, spec_bits, tone_out = core
    f = sfi.shape[1]
    tones = None
    if tone_out is not None:
        keys = jnp.where(tone_out["valid"], tone_out["freq"], 1 << 20)
        order = jnp.argsort(keys, axis=-1)
        tones = {k: (jnp.take_along_axis(v, order, axis=-1)
                     if v.ndim == 4 else v)
                 for k, v in tone_out.items()}
        tonal_bits = tonal_fields_device(tones, c)[3].astype(jnp.int32)
    else:
        tonal_bits = jnp.zeros((f,), jnp.int32)

    # NumQuantUnits shrink (CheckFrameDone, at3p_bitstream.cpp:529-541):
    # candidates 32, 28, 27, ..., 1; first whose total fits 2048*8-3 bits
    # (bit totals < 2^17, comfortably int32)
    budget = T.FRAME_BYTES * 8 - 3
    const_bits = jnp.asarray(_const_bits(c), jnp.int32)      # [33]
    spec_bits = spec_bits.astype(jnp.int32)
    cum = jnp.concatenate([jnp.zeros_like(spec_bits[..., :1]),
                           jnp.cumsum(spec_bits, axis=-1)], axis=-1)
    total = const_bits[None] + cum.sum(axis=0) + tonal_bits[:, None]
    cand = jnp.asarray([32] + list(range(28, 0, -1)), jnp.int32)
    fits = total[:, cand] <= budget                          # [F, 30]
    first = jnp.argmax(fits, axis=-1)                        # first True
    num_qu = jnp.where(fits.any(-1), cand[first], 1).astype(jnp.int32)
    out = {"num_qu": num_qu, "sfi": sfi, "mant": mant, "spec_tab": spec_tab}
    if tones is not None:
        out["tones"] = tones
    return out


@partial(jax.jit, static_argnames=("channels", "gha_mask", "wb_refine"))
def encode_frames_bytes(pcm, channels, gha_mask=7, wb_refine=None):
    """Fused whole-track device path: [C, T] PCM -> [F, 2048] frame bytes
    (T must be a multiple of NUM_SAMPLES — pad like encode_track does).
    Everything — PQF, GHA, MDCT, scale, VLC costing, numQU shrink, and
    bitstream serialization — stays on device; vmap over a stream axis for
    the batch-transcode/bench path."""
    from .device_pack import pack_device
    core = _core_impl(pcm, gha_mask, wb_refine, 0, 0, False, False)
    planes = _finish_planes_device(core, channels)
    return pack_device(planes, channels)


def _finish_planes(core, c):
    """Host tail shared by the whole-track and chunked paths: wire ordering
    of the tones, tonal-section bit costs, and the NumQuantUnits shrink."""
    sfi, mant, spec_tab, spec_bits, tone_out = core
    sfi, mant, spec_tab, spec_bits = (
        np.asarray(x) for x in (sfi, mant, spec_tab, spec_bits))
    tones = None
    if tone_out is not None:
        tones = jax.device_get(tone_out)
        # wire order wants ascending frequencies per band
        order = np.argsort(
            np.where(tones["valid"], tones["freq"], 1 << 20), axis=-1)
        tones = {k: (np.take_along_axis(v, order, axis=-1)
                     if v.ndim == 4 else v)
                 for k, v in tones.items()}
        # tonal-block bits on device, plane-wise (device_pack's field
        # widths; identical to the per-frame host walk it replaces)
        tonal_bits = np.asarray(_tonal_bits_fn(c)(tones), np.int64)
    else:
        tonal_bits = np.zeros(sfi.shape[1], np.int64)

    # NumQuantUnits shrink (CheckFrameDone, at3p_bitstream.cpp:529-541):
    # candidates 32, 28, 27, ... 1; first whose total fits 2048*8-3 bits
    budget = T.FRAME_BYTES * 8 - 3
    const_bits = _const_bits(c)
    cum = np.concatenate([np.zeros_like(spec_bits[..., :1]),
                          np.cumsum(spec_bits, axis=-1)], axis=-1)  # [C,F,33]
    total = const_bits[None] + cum.sum(axis=0) + tonal_bits[:, None]
    candidates = [32] + list(range(28, 0, -1))
    num_qu = np.full(total.shape[0], 1, np.int32)
    chosen = np.zeros(total.shape[0], bool)
    for nq in candidates:
        ok = ~chosen & (total[:, nq] <= budget)
        num_qu[ok] = nq
        chosen |= ok
    out = {
        "num_qu": num_qu,
        "sfi": sfi,
        "mant": mant,
        "spec_tab": spec_tab,
    }
    if tones is not None:
        out["tones"] = tones
    return out


def dryrun_sharded(mesh, mesh1):
    """Driver hook: jit the AT3P core over a (dp, sp) mesh on tiny shapes
    and assert bit-identity with single-device execution."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    s = max(2, dp)
    t = T.NUM_SAMPLES * 2 * sp
    rng = np.random.default_rng(2)
    pcm = (0.25 * rng.standard_normal((s, 2, t))).astype(np.float32)

    def enc(xs):
        return jax.vmap(lambda p: _encode_core(p, gha_mask=7))(xs)

    outs = {}
    for name, m in (("sharded", mesh), ("single", mesh1)):
        in_sh = NamedSharding(m, P("dp", None, "sp"))
        out_sh = NamedSharding(m, P("dp"))
        fn = jax.jit(enc, in_shardings=in_sh, out_shardings=out_sh)
        outs[name] = jax.device_get(fn(jax.device_put(
            jnp.asarray(pcm), in_sh)))
    flat_a = jax.tree.leaves(outs["sharded"])
    flat_b = jax.tree.leaves(outs["single"])
    for a, b in zip(flat_a, flat_b):
        assert np.array_equal(np.asarray(a), np.asarray(b)), \
            "AT3P sharded != unsharded"


def _num_tone_bands(tones):
    """[F] number of tone bands per output frame (0 = no tonal block)."""
    any_wave = tones["valid"].any(axis=-1).any(axis=0)   # [F, 8]
    nb = np.where(any_wave, np.arange(8)[None, :] + 1, 0).max(axis=-1)
    return nb.astype(np.int64)


def _tonal_section_bits(tones, channels):
    """Bits of the tonal block per frame (WriteTonalBlock dry run,
    at3p_bitstream.cpp:366-520); the 'tonal present' flag itself lives in
    the constant section.

    Test oracle for the device plane-wise `_tonal_bits_fn` the production
    path budgets with (tests/test_at3p_device_pack.py pins equality)."""
    from . import frame as fr
    nb = _num_tone_bands(tones)
    bits = np.zeros(nb.shape[0], np.int64)
    for fi in range(nb.shape[0]):
        if nb[fi]:
            bits[fi] = sum(w for _, w in fr.tonal_block_fields(
                tones, fi, channels, int(nb[fi])))
    return bits
