"""Mesh construction and sharded batch transcoding.

The reference is strictly single-threaded (SURVEY.md §2.7); scale-out is a
new capability of this framework:

  * dp ("stream") axis — independent tracks of a transcode corpus;
  * sp ("sample") axis — a single track's time axis.  Every DSP stage is a
    strided convolution or frame-local matmul, so XLA's SPMD partitioner
    shards the time axis with automatic halo exchange between devices; the
    loudness recurrence is an associative scan, which shards exactly as
    well.

One process drives every device of the host.  The caller chooses (dp, sp):
the cards of one GPU host are joined all to all, so no device order is
preferred.  All sharding logic is testable on a virtual CPU mesh
(xla_force_host_platform_device_count).
"""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from atracdenc_tpu.models.atrac1.encoder import encode_frames
from atracdenc_tpu.models.atrac3.encoder import encode_frames as at3_encode


def make_mesh(dp, sp=1):
    """A (dp, sp) mesh over the first dp * sp devices."""
    devices = jax.devices()
    if dp * sp > len(devices):
        raise ValueError(f"mesh ({dp}, {sp}) needs {dp * sp} devices, "
                         f"{len(devices)} present")
    return Mesh(np.asarray(devices[: dp * sp]).reshape(dp, sp), ("dp", "sp"))


def encode_batch(pcm):
    """[S, C, T] PCM batch -> ATRAC1 frame planes, batched over streams.

    The clip_* operator diagnostics are dropped: they expose RAW float
    maxima, and XLA's spatially-partitioned convolutions differ by ~1 ulp
    at shard-boundary frames — real but meaningless here, while every
    wire plane stays bit-identical (tests/test_mesh.py pins that)."""
    planes = jax.vmap(lambda p: encode_frames(p))(pcm)
    return {k: v for k, v in planes.items()
            if k not in ("clip_count", "clip_max")}


def encode_batch_sharded(pcm, mesh):
    """Shard a PCM batch over (stream, time) and encode.

    pcm: [S, C, T] with S % dp == 0 and T % (sp * 512) == 0.
    """
    in_sharding = NamedSharding(mesh, P("dp", None, "sp"))
    out_sharding = NamedSharding(mesh, P("dp"))
    fn = jax.jit(encode_batch, in_shardings=in_sharding,
                 out_shardings=out_sharding)
    return fn(jax.device_put(pcm, in_sharding))


def encode_batch_at3(pcm, js=False, frame_bytes=384):
    """[S, C, T] PCM batch -> ATRAC3 default-mode frame planes."""
    return jax.vmap(lambda p: at3_encode(
        p, frame_bytes=frame_bytes, js=js,
        no_gain_control=False, no_tonal=False))(pcm)


def encode_batch_at3_sharded(pcm, mesh):
    """Shard an ATRAC3 batch over (stream, time) and encode."""
    in_sharding = NamedSharding(mesh, P("dp", None, "sp"))
    out_sharding = NamedSharding(mesh, P("dp"))
    fn = jax.jit(encode_batch_at3, in_shardings=in_sharding,
                 out_shardings=out_sharding)
    return fn(jax.device_put(pcm, in_sharding))


def encode_batch_at3_bytes_sharded(pcm, mesh, js=False, frame_bytes=384):
    """Sharded ATRAC3 encode INCLUDING on-device serialization: the frame
    axis of the bit-deposit matmuls shards like any batch axis, so final
    frame bytes come out already distributed over the mesh.

    pcm: [S, C, T] -> [S, F, frame_bytes] uint8 sharded over dp."""
    from atracdenc_tpu.models.atrac3.device_pack import pack_device_batch

    def enc(p):
        return pack_device_batch(encode_batch_at3(p, js, frame_bytes),
                                 frame_bytes, js)

    in_sharding = NamedSharding(mesh, P("dp", None, "sp"))
    out_sharding = NamedSharding(mesh, P("dp"))
    fn = jax.jit(enc, in_shardings=in_sharding, out_shardings=out_sharding)
    return fn(jax.device_put(pcm, in_sharding))


def decode_batch_at1(planes):
    """[S, ...] AT1 frame planes -> [S, C, T] PCM (batched JAX decoder)."""
    from atracdenc_tpu.models.atrac1.decoder import decode_frames

    return jax.vmap(decode_frames)(
        planes["short_mask"], planes["wordlen"], planes["sfi"],
        planes["mant"])


def decode_batch_at1_sharded(planes, mesh, spec=P("dp")):
    """Sharded AT1 decode.  The default shards streams only (dp), so the
    QMF synthesis convolutions run unsplit per stream.  Decoded PCM is
    raw conv output, and XLA:CPU vectorizes conv reductions differently
    per local batch size, so sharded-vs-single floats can differ by a few
    ulps (~3e-7) even though no sample crosses a shard — the same reason
    encode's clip_* diagnostics are excluded from byte-equality
    (encode_batch).  The encode WIRE planes stay byte-equal because they
    are decision-quantized; decode equality is asserted to a 1e-6
    tolerance instead."""
    in_sh = NamedSharding(mesh, spec)
    out_sh = NamedSharding(mesh, P("dp"))
    args = {k: jax.device_put(jnp.asarray(planes[k]), in_sh)
            for k in ("short_mask", "wordlen", "sfi", "mant")}
    fn = jax.jit(decode_batch_at1, in_shardings=(in_sh,),
                 out_shardings=out_sh)
    return fn(args)


def dryrun(dp: int, sp: int) -> None:
    """Compile + run sharded encode steps on tiny shapes AND assert the
    sharded results equal the single-device results byte-for-byte (the
    real mesh tests are tests/test_mesh.py)."""
    mesh = make_mesh(dp, sp)
    mesh1 = make_mesh(1, 1)
    s = 2 * dp
    rng = np.random.default_rng(0)

    t = 512 * 2 * sp
    pcm = (0.25 * rng.standard_normal((s, 2, t))).astype(np.float32)
    planes = encode_batch_sharded(jnp.asarray(pcm), mesh)
    ref = encode_batch_sharded(jnp.asarray(pcm), mesh1)
    assert planes["wordlen"].shape == (s, 2, t // 512, 52)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), np.asarray(planes[k])), \
            f"AT1 sharded != unsharded: {k}"

    t3 = 1024 * 2 * sp
    pcm3 = (0.25 * rng.standard_normal((s, 2, t3))).astype(np.float32)
    frames3 = encode_batch_at3_bytes_sharded(jnp.asarray(pcm3), mesh)
    ref3 = encode_batch_at3_bytes_sharded(jnp.asarray(pcm3), mesh1)
    assert frames3.shape == (s, t3 // 1024, 384)
    assert np.array_equal(np.asarray(ref3), np.asarray(frames3)), \
        "AT3 sharded bytes != unsharded bytes"
    print("dryrun: AT1 planes + AT3 bytes byte-equal on the mesh",
          flush=True)

    # joint stereo: M/S matrixing, the loudness-ratio byte-budget shift and
    # the reversed channel-1 deposit all ride the same shardings
    js = encode_batch_at3_bytes_sharded(jnp.asarray(pcm3), mesh,
                                        js=True, frame_bytes=192)
    js1 = encode_batch_at3_bytes_sharded(jnp.asarray(pcm3), mesh1,
                                         js=True, frame_bytes=192)
    assert np.array_equal(np.asarray(js1), np.asarray(js)), \
        "AT3 JS sharded bytes != unsharded bytes"
    print("dryrun: AT3 JS bytes byte-equal on the mesh", flush=True)

    # AT1 decode round trip (streams sharded over dp; tolerance per
    # decode_batch_at1_sharded — raw conv floats shift by ulps with the
    # local batch size)
    dec = decode_batch_at1_sharded(planes, mesh)
    dec1 = decode_batch_at1_sharded(planes, mesh1)
    derr = float(np.max(np.abs(np.asarray(dec1) - np.asarray(dec))))
    assert derr <= 1e-6, f"AT1 sharded decode off by {derr}"
    print("dryrun: AT1 decode round-trip equal on the mesh "
          f"(max dev {derr:.2e})", flush=True)

    from atracdenc_tpu.models.atrac3p.encoder import dryrun_sharded as p_dry
    p_dry(mesh, mesh1)
    print("dryrun: AT3P core equal on the mesh", flush=True)
