"""atracdenc_tpu — a batched ATRAC1/ATRAC3/ATRAC3+ audio codec framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++ transcoder `atracdenc` (dcherednik/atracdenc).  The reference processes
audio one 512/1024/2048-sample frame at a time through stateful C++ objects;
this framework instead treats a whole track (or a slab of it) as a tensor of
frames and runs every DSP stage batched over ``[stream, frame, channel, ...]``
axes so the work maps onto wide vector and matrix units, with cross-frame state expressed
as halos (filterbank histories, MDCT overlap) or ``lax.scan`` carries
(loudness IIR).  Variable-length entropy/bitstream serialization runs on the
host (C++ native library with a NumPy fallback).

Layout:
  ops/         shared DSP kernels (MDCT, QMF, transient detect, scaling, psy)
  models/      codec pipelines (atrac1, atrac3, atrac3p)
  containers/  AEA / OMA / RIFF-AT3 / RealMedia / RAW framing
  io/          PCM (WAV) reading and writing
  parallel/    device-mesh sharding of the batch transcoder
  utils/       bit packing and host-side helpers
  native/      C++ host runtime (bitstream finalization, containers)
"""

__version__ = "0.1.0"

# Constant discipline: module-level table constants in this package are
# HOST numpy arrays, never jax.Arrays (see utils/npconst.py).  numpy closure
# constants are baked into the HLO as literals; a jax.Array closure
# constant becomes a runtime argument of the executable instead, passed on
# every call and taking the process off JAX's C++ fast dispatch path.
# Enforced by tests/test_dispatch_hygiene.py.
