"""Benchmark: ATRAC3 default-mode encode throughput on one GPU.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
Exits non-zero without a JSON line when JAX finds no GPU.

Baseline: the reference C++ encoder (dcherednik/atracdenc, -O2, one CPU
core) in its default mode (gain control + tonal components, 132 kbit/s
LP2) at 1046 stereo frames/s (one frame = 1024 samples x 2 channels),
measured on the x86 host CPU recorded in BASELINE.md on a 47.5 s stereo
corpus (997 Hz tone + noise).

The whole pipeline — DSP, psychoacoustics, rate control and bitstream
serialization (models/atrac3/device_pack.py + ops/bitdeposit.py) — runs on
the device; only the final 384-byte frames are copied to the host.
"""
import json
import subprocess
import sys
import time

import numpy as np

REF_FRAMES_PER_S = 1046.0        # reference at3enc, 1 CPU core (BASELINE.md)
REF_AT1_UNITS_PER_S = 11670.0    # reference at1enc, 1 CPU core
REF_AT3P_FRAMES_PER_S = 930.0    # at3p_oracle (GHA-off flow), 1 CPU core

# The batch every AT3 measurement uses: 64 streams x 256 frames = 16,384
# stereo frames (about 6 s of audio per stream).
AT3_STREAMS, AT3_FRAMES = 64, 256


def nvidia_smi_line():
    """`name, power.limit` of every card, as nvidia-smi prints them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return r.stdout.strip() or r.stderr.strip()


def make_pcm(streams, samples, seed=42, channels=2):
    """[streams, channels, samples] f32: a 997 Hz tone plus noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(samples, dtype=np.float64)
    base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    gains = np.asarray([1.0, 0.8][:channels])
    return np.clip(base[None, None, :] * gains[None, :, None]
                   + 0.05 * rng.standard_normal((streams, channels, samples)),
                   -1, 1).astype(np.float32)


def at3_bytes_batch(frame_bytes=384, js=False):
    """Jitted [S, C, T] PCM -> [S, F, frame_bytes] uint8: the fused AT3
    default-mode encode (gain control + tonal) and device pack."""
    import jax
    from atracdenc_tpu.models.atrac3.encoder import encode_frames
    from atracdenc_tpu.models.atrac3.device_pack import pack_device_batch

    return jax.jit(lambda xs: pack_device_batch(
        jax.vmap(lambda p: encode_frames(
            p, frame_bytes=frame_bytes, js=js, no_gain_control=False,
            no_tonal=False))(xs), frame_bytes, js))


def pipeline_rate(batched, x, n_items, iters=6):
    """Steady-state items/s of jitted `batched(x)`: one warm-up call, then
    `iters` calls whose outputs are all copied to the host inside the
    timed window.  Returns (items/s, warm-up seconds)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(batched(x))
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [batched(x) for _ in range(iters)]
    jax.device_get(outs)
    return n_items * iters / (time.perf_counter() - t0), warm


def at1_batch():
    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.models.atrac1.encoder import encode_frames
    from atracdenc_tpu.models.atrac1.device_pack import pack_device

    def one(p):
        planes = encode_frames(p)
        merged = {k: jnp.swapaxes(v, 0, 1).reshape((-1,) + v.shape[2:])
                  for k, v in planes.items()}
        return pack_device(merged)

    return jax.jit(lambda xs: jax.vmap(one)(xs))


def _at3p_batch(channels):
    """Full-GHA AT3P, stream-vmapped fused device path: PQF, GHA tonal
    model, MDCT, VLC costing, numQU shrink and serialization in one jit."""
    import jax
    from atracdenc_tpu.models.atrac3p.encoder import encode_frames_bytes

    return jax.jit(lambda xs: jax.vmap(
        lambda p: encode_frames_bytes(p, channels, gha_mask=7))(xs))


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    pcm = make_pcm(AT3_STREAMS, 1024 * AT3_FRAMES)
    fps, at3_warm = pipeline_rate(at3_bytes_batch(), jnp.asarray(pcm),
                                  AT3_STREAMS * AT3_FRAMES)

    at1_pcm = jnp.asarray(pcm[:8, :, :512 * 512])
    at1_rate, _ = pipeline_rate(at1_batch(), at1_pcm, 8 * 2 * 512)
    at3p_pcm = jnp.asarray(pcm[:8, :, :2048 * 128])
    at3p_rate, _ = pipeline_rate(_at3p_batch(2), at3p_pcm, 8 * 128)
    stats = dev.memory_stats() or {}

    print(json.dumps({
        "metric": "atrac3_default_encode_throughput",
        "value": fps,
        "unit": "stereo_frames_per_s",
        "vs_baseline": fps / REF_FRAMES_PER_S,
        "extra": {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "nvidia_smi": nvidia_smi_line(),
            "at3_warmup_s": at3_warm,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "atrac1_units_per_s": at1_rate,
            "atrac1_vs_baseline": at1_rate / REF_AT1_UNITS_PER_S,
            "at3p_gha_frames_per_s": at3p_rate,
            "at3p_vs_gha_off_oracle": at3p_rate / REF_AT3P_FRAMES_PER_S,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
