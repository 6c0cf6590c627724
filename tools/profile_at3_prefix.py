"""In-context stage attribution for the fused ATRAC3 pipeline.

Standalone per-stage jits (tools/profile_at3.py) mismeasure fused cost:
a stage timed alone pays HBM materialization of its inputs/outputs that
the fused end-to-end graph never pays (and vice versa: XLA fuses stages
into each other).  This tool instead times PREFIXES of the exact
full-mode pipeline — the same calls in the same order as
encoder.encode_frames_chunk (js=False, gain control + tonal on) — each
prefix reduced to a scalar so only compute is timed.  The difference
between successive prefixes is the honest in-context cost of the stage.

  python tools/profile_at3_prefix.py [--streams 32] [--nframes 512]
                                     [--iters 4]
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))



def main():
    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--nframes", type=int, default=512)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac3 import encoder as E
    from atracdenc_tpu.models.atrac3 import bitalloc, tonal
    from atracdenc_tpu.models.atrac3 import tables as T
    from atracdenc_tpu.models.atrac3.device_pack import pack_device
    from atracdenc_tpu.ops import psy, scale as scale_ops

    rng = np.random.default_rng(0)
    t = 1024 * args.nframes
    n = np.arange(t)
    base = 0.3 * np.sin(2 * np.pi * 997 * n / 44100)
    pcm = np.stack([base + 0.05 * rng.standard_normal(t),
                    0.7 * base + 0.05 * rng.standard_normal(t)]
                   ).astype(np.float32)
    xs = jnp.asarray(np.broadcast_to(pcm, (args.streams,) + pcm.shape))
    frames = args.streams * args.nframes
    print(f"batch: {args.streams} x {args.nframes} frames = {frames}")

    frame_bytes = 384

    def pipeline(p, upto):
        """Mirror of encode_frames_chunk (full mode, js=False) truncated
        after stage `upto`; returns a scalar keeping all live values."""
        from atracdenc_tpu.models.atrac3 import gain
        from atracdenc_tpu.models.atrac3.mdct import (
            mdct_frames, gain_divisors, first_level_scale)

        c, tt = p.shape
        f = tt // T.NUM_SAMPLES
        state = E.init_state(c)
        ext = jnp.concatenate([state["pcm_tail"], p], axis=-1)
        bands = E.band_frames(ext)[:, 1:]
        next_head = jnp.zeros((c, 4, 128), p.dtype)
        if upto == 0:
            return jnp.sum(bands)

        gain_levels, gain_locs, gain_npoints, _ = gain.gain_control(
            bands, ctx=state["gain"], next_head=next_head)
        div = gain_divisors(gain_levels, gain_locs, gain_npoints)
        scale = first_level_scale(gain_levels, gain_npoints)
        gain_scale_frame, es_carry = gain.energy_scale(
            bands, div, scale, prev_half=state["mdct_prev"],
            prev_overlap_init=state["next_overlap"])
        specs = mdct_frames(bands, div, scale, prev_half=state["mdct_prev"])
        if upto == 1:
            return jnp.sum(specs) + jnp.sum(gain_scale_frame)

        gs_per_line = jnp.repeat(gain_scale_frame, 256, axis=-1)
        frame_loud = jnp.sum(specs * specs * gs_per_line * E._LOUD_CURVE,
                             axis=-1)
        loud = psy.track_loudness_scan(
            frame_loud[0], frame_loud[1], jnp.ones((f,), bool),
            jnp.zeros((f,), bool), state["loudness"])
        loudness = loud / T.LOUD_FACTOR
        if upto == 2:
            return jnp.sum(loudness) + jnp.sum(specs)

        flat = tonal.flatness_per_bfu(specs * specs)
        specs, tp = tonal.extract(specs, flat)
        tonal_planes = tonal.scale_groups(tp)
        bfu_oh = jax.nn.one_hot(tonal_planes["bfu"], 32, dtype=jnp.int32)
        tonal_counts = jnp.sum(
            bfu_oh * tonal_planes["active"][..., None].astype(jnp.int32),
            axis=-2)
        tonal_bits_fn = tonal.make_cost_fn(tonal_planes)
        if upto == 3:
            return (jnp.sum(specs) + jnp.sum(tonal_counts)
                    + jnp.sum(tonal_planes["vlc_cost"]))

        blocks = E.gather_bfu_blocks(specs)
        sfi, scaled, energy = scale_ops.scale_blocks(
            blocks, E._GATHER_MASK, E._SCALE_TABLE)
        spread = E.spread_from_sfi(sfi)
        half = frame_bytes // 2
        id_bits = jnp.asarray([6 for _ in range(c)])[:, None]
        header_bits = id_bits + 2 + jnp.sum(3 + gain_npoints * 9, axis=-1)
        target = jnp.maximum(8 * half - 6 - header_bits, 1).astype(jnp.int32)
        if upto == 4:
            return jnp.sum(scaled) + jnp.sum(energy) + jnp.sum(target)

        qt = bitalloc.quant_tensors(scaled, E._GATHER_MASK)
        if upto == 5:
            return (jnp.sum(qt["err"]) + jnp.sum(qt["clc"])
                    + jnp.sum(qt["vlc"]))

        num_bfu, mode, wl = bitalloc.allocate(
            qt, sfi, gain_scale_frame, energy, spread,
            jnp.broadcast_to(loudness, (c, f)), target,
            tonal_counts=tonal_counts, tonal_bits_fn=tonal_bits_fn)
        if upto == 6:
            return jnp.sum(num_bfu) + jnp.sum(wl) + jnp.sum(mode)

        mant = bitalloc.final_mantissas(scaled, E._GATHER_MASK, wl)
        if upto == 7:
            return jnp.sum(mant.astype(jnp.int32)) + jnp.sum(wl)

        active, quant = tonal.block_quant(tonal_planes, wl, num_bfu)
        ohq = jax.nn.one_hot(quant, 8, dtype=jnp.int8)
        out = {
            "num_bfu": num_bfu.astype(jnp.int8),
            "coding_mode": mode,
            "wordlen": wl.astype(jnp.int8),
            "sfi": sfi.astype(jnp.int8),
            "mant": mant,
            "gain_npoints": gain_npoints.astype(jnp.int8),
            "gain_levels": gain_levels.astype(jnp.int8),
            "gain_locs": gain_locs.astype(jnp.int8),
            "loudness": loudness,
            "ms_shift": jnp.zeros((f,), jnp.int32),
            "tonal_active": active,
            "tonal_start": tonal_planes["start"].astype(jnp.int16),
            "tonal_len": tonal_planes["len"].astype(jnp.int8),
            "tonal_sfi": tonal_planes["sfi"].astype(jnp.int8),
            "tonal_quant": jnp.where(active, quant, 0).astype(jnp.int8),
            "tonal_mant": jnp.sum(
                tonal_planes["mant"].astype(jnp.int8) * ohq[..., None],
                axis=-2).astype(jnp.int8),
        }
        bytes_ = pack_device(out, frame_bytes, False)
        return jnp.sum(bytes_.astype(jnp.int32))

    names = ["bands", "+gain/mdct", "+loudness", "+tonal", "+scale",
             "+quant_tensors", "+allocate", "+final_mant", "+pack"]
    prev = 0.0
    for k, name in enumerate(names):
        fn = jax.jit(lambda xs, k=k: jnp.sum(
            jax.vmap(lambda p: pipeline(p, k))(xs)))
        from tools._timing import measure
        try:
            dt = measure(fn, xs, iters=max(args.iters, 4))
        except Exception as exc:
            print(f"{name:18s} FAILED: {str(exc)[:100]}")
            continue
        print(f"{name:18s} {dt * 1e3:9.2f} ms  (+{(dt - prev) * 1e3:8.2f} ms"
              f")  {frames / max(dt, 1e-9):10.0f} f/s")
        prev = dt
        sys.stdout.flush()


if __name__ == "__main__":
    main()
