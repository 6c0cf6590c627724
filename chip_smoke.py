"""Bring-up smoke test: the package's main paths on one GPU, at real sizes.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the (dp, sp) mesh only

Phases (one card, one process): device; kernels against their plain XLA
forms; golden bytes against the reference oracle; the CLI end to end on a
generated 240-s stereo track; the batch transcoder on three tracks of
uneven length; the batched bytes path at bench.py's shape; the
`chip`-marked tests.  Golden, CLI, transcode and batch run concurrently,
and so do the independent jobs inside golden and CLI: a cold run compiles
a few dozen XLA programs, and compiling them one after another would not
fit the time a smoke test may take.  Each phase prints one line, in the
order above, with its compile seconds (summed over its threads), its wall
seconds and its check figures.  The last line is a JSON object with
"ok": true, printed only when every phase passed.  Without a GPU the
script exits non-zero and prints no result.
"""
import argparse
import collections
import json
import os
import shutil
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 44100
TRACK_S = 240                     # 10,336 AT3 frames, 20,672 AT1 units
EXACT_S = 10                      # prefix compared with the --exact path
DECODE_S = 30                     # prefix decoded for the SNR checks
# SNR floors (dB) of the decoded CLI outputs against the input track; the
# codecs' measured SNRs on this signal sit well above them, so a floor
# catches a broken path, not a quality regression (the golden phase pins
# quality against the reference)
SNR_FLOOR = {"atrac1": 12.0, "atrac3": 10.0, "atrac3_lp4": 6.0,
             "atrac3plus": 8.0}

_PHASE = threading.local()
_COMPILE_S = collections.defaultdict(float)     # phase -> compile seconds


def _on_compile(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE_S[getattr(_PHASE, "name", "-")] += duration


def _in_phase(name, fn, *args):
    _PHASE.name = name
    return fn(*args)


def _parallel(jobs):
    """Run {key: callable} in threads of the calling phase; return
    {key: result}, raising the first failure after all have ended."""
    name = getattr(_PHASE, "name", "-")
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futs = {k: ex.submit(_in_phase, name, fn) for k, fn in jobs.items()}
    errors = [f.exception() for f in futs.values() if f.exception()]
    if errors:
        raise errors[0]
    return {k: f.result() for k, f in futs.items()}


# --------------------------------------------------------------------------
# signals and checks
# --------------------------------------------------------------------------

def make_track(seconds, seed):
    """[2, seconds*44100] f32: a tone with vibrato, noise, and a few
    transients (short bursts that trigger short windows and gain
    control)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 220.0 * 2 ** rng.uniform(0, 2)
    tone = 0.3 * np.sin(2 * np.pi * f0 * t + 2.0 * np.sin(2 * np.pi * 0.5 * t))
    x = np.stack([tone, 0.8 * tone]) + 0.03 * rng.standard_normal((2, t.size))
    for start in rng.uniform(0, seconds - 0.1, max(3, int(seconds / 20))):
        i = int(start * SR)
        n = int(0.02 * SR)
        x[:, i:i + n] += (0.6 * rng.standard_normal((2, n))
                          * np.exp(-np.arange(n) / (0.004 * SR)))
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def snr_db(ref, out, max_lag=8192):
    """SNR (dB) of `out` against `ref` at the lag in [-max_lag, max_lag]
    and the polarity that correlate best on channel 0 (decoders may keep
    the codec delay).  Returns (snr, lag)."""
    ref = ref.astype(np.float64)
    out = out.astype(np.float64)
    n = min(ref.shape[1], out.shape[1]) - 2 * max_lag
    a = ref[0, max_lag:max_lag + n]
    b = out[0, :n + 2 * max_lag]
    size = 1 << int(np.ceil(np.log2(len(a) + len(b))))
    corr = np.fft.irfft(np.fft.rfft(b, size) * np.conj(np.fft.rfft(a, size)),
                        size)[:2 * max_lag + 1]         # corr[k]: b[k:] vs a
    k = int(np.argmax(np.abs(corr)))
    sign = 1.0 if corr[k] >= 0 else -1.0
    x = ref[:, max_lag:max_lag + n]
    y = sign * out[:, k:k + n]
    snr = 10 * np.log10(np.sum(x ** 2) / max(np.sum((x - y) ** 2), 1e-20))
    return float(snr), k - max_lag


def _cli(argv):
    from atracdenc_tpu import cli
    try:
        rc = cli.main(argv)
    except SystemExit as exc:
        rc = exc.code
    if rc not in (0, None):
        raise RuntimeError(f"cli {argv} -> {rc}")


def _identity(a, b, n):
    return float((a[:n] == b[:n]).mean())


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------

def phase_kernels(ctx):
    """Each hand-written kernel at the widths of the 64x256 AT3 batch
    against its plain XLA form: bit equality and both device times."""
    import jax
    import jax.numpy as jnp
    from atracdenc_tpu.ops.pallas_greedy import greedy_scan
    from atracdenc_tpu.ops.quant import greedy_scan_xla

    figs = {}
    # EA groups of 32,768 channel-frames: rows = frames x BFUs x 6 lanes
    for rows, L in ((32768 * 7 * 6, 32), (32768 * 4 * 6, 64),
                    (32768 * 2 * 6, 128)):
        rng = np.random.default_rng(rows)
        m = rng.integers(-32, 33, (rows, L))
        mn = m + np.where(m >= 0, 1, -1)
        inv2 = (rng.random((rows, 1)) + 0.01).astype(np.float32)
        args = (jnp.asarray((m * m).astype(np.float32) * inv2),
                jnp.asarray((mn * mn).astype(np.float32) * inv2),
                jnp.asarray(rng.random((rows, L)) < 0.4),
                jnp.asarray(rng.random(rows).astype(np.float32) * 50.0),
                jnp.asarray(rng.random(rows).astype(np.float32) * 50.0))
        times = {}
        outs = {}
        for name, fn in (("triton", greedy_scan),
                         ("xla", jax.jit(greedy_scan_xla))):
            outs[name] = jax.block_until_ready(fn(*args))
            t0 = time.perf_counter()
            for _ in range(5):
                jax.block_until_ready(fn(*args))
            times[name] = (time.perf_counter() - t0) / 5
        equal = all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(outs["triton"], outs["xla"]))
        if not equal:
            raise AssertionError(f"greedy_scan != XLA scan at {rows}x{L}")
        figs[f"greedy_{rows}x{L}_s"] = times
    return figs


def phase_golden(ctx):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import golden_check

    jobs = {"at3_" + c[0]: (lambda c=c: golden_check.at3_case(*c))
            for c in golden_check.CASES}
    jobs.update({"at1_" + n.split(".")[0]: (lambda n=n, r=r:
                                            golden_check.at1_case(n, r))
                 for n, r in golden_check.AT1_CASES})
    jobs["at1_decode"] = golden_check.at1_decode_case
    jobs.update({"at3p_" + p: (lambda p=p, r=r: golden_check.at3p_case(p, r))
                 for p, r in golden_check.AT3P_CASES})
    res = {k: {kk: vv for kk, vv in v.items() if kk not in ("eq", "ours",
                                                            "ref")}
           for k, v in _parallel(jobs).items()}
    bad = [k for k, v in res.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"below floor: {bad}: "
                             f"{json.dumps({k: res[k] for k in bad})}")
    return res


def phase_cli(ctx, seconds=TRACK_S, exact_s=EXACT_S, decode_s=DECODE_S):
    from atracdenc_tpu.containers import aea, oma
    from atracdenc_tpu.io import wav

    work = ctx["work"]
    pcm = make_track(seconds, seed=1)
    src = os.path.join(work, "track.wav")
    wav.write(src, pcm)
    pcm_q, _ = wav.read(src)           # what the encoders see (16-bit)
    short = os.path.join(work, "track_10s.wav")
    wav.write(short, pcm_q[:, :exact_s * SR])
    from atracdenc_tpu.models.atrac3.decoder import decode_track as at3_dec
    from atracdenc_tpu.models.atrac3p.decoder import decode_track as at3p_dec

    def snr_of(decoded, codec):
        n = decode_s * SR
        s, lag = snr_db(pcm_q[:, :n], decoded[:, :n])
        if not s > SNR_FLOOR[codec]:
            raise AssertionError(f"{codec}: SNR {s:.2f} dB <= "
                                 f"{SNR_FLOOR[codec]} dB")
        return {codec + "_snr_db": s, codec + "_lag": lag}

    def atrac1():
        # ATRAC1 -> .aea, decoded back by the CLI
        _cli(["-e", "atrac1", "-i", src, "-o", out["atrac1"], "--nostdout"])
        dec = os.path.join(work, "t_at1.wav")
        _cli(["-d", "-i", out["atrac1"], "-o", dec, "--nostdout"])
        return snr_of(wav.read(dec)[0], "atrac1")

    def atrac3_family(codec):
        # ATRAC3 LP2 (132 kbit/s, gain + tonal), LP4 (JS), ATRAC3plus
        _cli(["-e", codec, "-i", src, "-o", out[codec], "--nostdout"])
        frames, info = oma.read(out[codec])
        if codec == "atrac3plus":
            decoded = at3p_dec(frames[:decode_s * SR // 2048 + 4],
                               info["channels"])
        else:
            decoded = at3_dec(frames[:decode_s * SR // 1024 + 4],
                              info["channels"],
                              js=info.get("joint_stereo", False))
        return snr_of(decoded, codec)

    def exact(codec):
        _cli(["-e", codec, "--exact", "-i", short, "-o",
              out[codec + "_exact"], "--nostdout"])
        return {}

    out = {k: os.path.join(work, k + (".aea" if "atrac1" in k else ".oma"))
           for k in ("atrac1", "atrac1_exact", "atrac3", "atrac3_exact",
                     "atrac3_lp4", "atrac3plus")}
    jobs = {"atrac1": atrac1, "atrac1_exact": lambda: exact("atrac1"),
            "atrac3_exact": lambda: exact("atrac3")}
    jobs.update({c: (lambda c=c: atrac3_family(c))
                 for c in ("atrac3", "atrac3_lp4", "atrac3plus")})
    figs = {}
    for r in _parallel(jobs).values():
        figs.update(r)

    # the first frames of the 240-s fast encode against the --exact
    # encode of its first seconds (the last few frames of the short file
    # see its end); floors: AT1 as its fast path's golden identity class
    # (docs/BYTE_IDENTITY.md), AT3 default mode as test_at3_gain
    fa, fe = aea.read(out["atrac1"])[0], aea.read(out["atrac1_exact"])[0]
    figs["atrac1_exact_identity"] = _identity(fa, fe, len(fe) - 4)
    fa, fe = oma.read(out["atrac3"])[0], oma.read(out["atrac3_exact"])[0]
    figs["atrac3_exact_identity"] = _identity(fa, fe, len(fe) - 2)
    for key, floor in (("atrac1_exact_identity", 0.94),
                       ("atrac3_exact_identity", 0.98)):
        if not figs[key] > floor:
            raise AssertionError(f"{key} {figs[key]:.4f} <= {floor}")
    return figs


def phase_transcode(ctx, lengths=(30, 95, 240)):
    from atracdenc_tpu.containers import oma
    from atracdenc_tpu.io import wav
    from atracdenc_tpu.models.atrac3.decoder import decode_track
    from atracdenc_tpu.tools import transcode

    work = ctx["work"]
    srcs = []
    for i, s in enumerate(lengths):
        p = os.path.join(work, f"corpus_{i}.wav")
        wav.write(p, make_track(s, seed=10 + i))
        srcs.append(p)
    out_dir = os.path.join(work, "enc")
    rc = transcode.main(srcs + ["--codec", "atrac3", "--out-dir", out_dir])
    if rc:
        raise RuntimeError(f"transcode -> {rc}")
    figs = {}
    for i, (p, s) in enumerate(zip(srcs, lengths)):
        out = os.path.join(out_dir, f"corpus_{i}.oma")
        frames, info = oma.read(out)
        expect = -(-s * SR // 1024)
        if abs(len(frames) - expect) > 2:
            raise AssertionError(f"{out}: {len(frames)} frames, "
                                 f"expected ~{expect}")
        n = 10 * SR
        decoded = decode_track(frames[:n // 1024 + 4], info["channels"])
        snr, _ = snr_db(wav.read(p)[0][:, :n], decoded[:, :n])
        figs[f"track{i}_{s}s"] = {"frames": len(frames), "snr_db": snr}
        if not snr > SNR_FLOOR["atrac3"]:
            raise AssertionError(f"{out}: SNR {snr:.2f} dB")
    return figs


def phase_batch(ctx, streams=None, frames=None):
    """The fused encode + device pack at bench.py's shape; bytes equal the
    host packer's for the same planes on two streams."""
    import jax
    import jax.numpy as jnp
    import bench
    from atracdenc_tpu.models.atrac3 import frame as at3_frame
    from atracdenc_tpu.models.atrac3.device_pack import pack_device_batch
    from atracdenc_tpu.models.atrac3.encoder import encode_frames

    streams = streams or bench.AT3_STREAMS
    frames = frames or bench.AT3_FRAMES
    x = jnp.asarray(bench.make_pcm(streams, 1024 * frames))

    @jax.jit
    def fn(xs):
        planes = jax.vmap(lambda p: encode_frames(
            p, frame_bytes=384, js=False, no_gain_control=False,
            no_tonal=False))(xs)
        return planes, pack_device_batch(planes, 384, False)

    planes, dev_bytes = jax.device_get(fn(x))
    for s in (0, streams - 1):
        host = at3_frame.pack({k: v[s] for k, v in planes.items()}, 384)
        if not np.array_equal(host, dev_bytes[s]):
            raise AssertionError(f"stream {s}: device pack != host pack")
    ctx["batch"] = (fn, x, streams * frames)
    return {"stereo_frames": streams * frames, "streams_checked": 2}


def phase_batch_rate(ctx, iters=3):
    """The batch of phase_batch alone on the card: stereo frames/s with
    every output copied to the host, and the process's peak memory."""
    import jax

    fn, x, n = ctx["batch"]
    t0 = time.perf_counter()
    jax.device_get([fn(x)[1] for _ in range(iters)])
    stats = ctx["dev"].memory_stats() or {}
    return {"frames_per_s": n * iters / (time.perf_counter() - t0),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def phase_chip_tests(ctx):
    import pytest

    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    if rc != 0:
        raise AssertionError(f"chip tests -> pytest exit {rc}")
    return {"pytest_rc": int(rc)}


# --------------------------------------------------------------------------
# four-card phase
# --------------------------------------------------------------------------

def phase_mesh(ctx, streams=None, frames=None, track_s=TRACK_S,
               small_frames=64):
    """(dp, sp) shardings over four cards, each against the same call on
    a one-device mesh: byte-equal; AT1 decode within 1e-6.  The checks
    are independent and run concurrently (their compiles overlap)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import bench
    from atracdenc_tpu.models.atrac3p import encoder as PE
    from atracdenc_tpu.models.atrac3p import tables as PT
    from atracdenc_tpu.parallel import mesh as M

    one = M.make_mesh(1, 1)
    streams = streams or bench.AT3_STREAMS
    frames = frames or bench.AT3_FRAMES

    def dev_of(a, b, tol=0.0):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        dev = max(float(np.max(np.abs(np.asarray(x, np.float64)
                                      - np.asarray(y, np.float64))))
                  for x, y in zip(la, lb))
        if dev > tol:
            raise AssertionError(f"sharded != one device (max dev {dev})")
        return dev

    def timed(fn, mesh):
        t0 = time.perf_counter()
        out = jax.device_get(fn(mesh))
        return out, time.perf_counter() - t0

    # dp=4: the 64x256 AT3 bytes batch
    x = jnp.asarray(bench.make_pcm(streams, 1024 * frames))
    # sp=4: one 240-s track (a whole number of 4 x 1024-sample frames),
    # halo exchange between the cards
    t = track_s * SR // 4096 * 4096 + 4096
    track = jnp.asarray(make_track(t / SR, seed=1)[None, :, :t])
    # (2, 2): AT3-JS bytes, AT1 decode, the AT3P core
    pcm = jnp.asarray(bench.make_pcm(8, 1024 * small_frames, seed=3))
    p3 = jnp.asarray(bench.make_pcm(4, PT.NUM_SAMPLES * small_frames,
                                    seed=5))

    def at1_decode(m):
        planes = M.encode_batch_sharded(pcm, M.make_mesh(2, 2))
        return M.decode_batch_at1_sharded(planes, m)

    def at3p_core(m):
        sh = NamedSharding(m, P("dp", None, "sp"))
        fn = jax.jit(lambda xs: jax.vmap(lambda p: PE._encode_core(
            p, gha_mask=7, wb_refine=True))(xs),
            in_shardings=sh, out_shardings=NamedSharding(m, P("dp")))
        return fn(jax.device_put(p3, sh))

    checks = {
        "dp4_at3_bytes": (lambda m: M.encode_batch_at3_bytes_sharded(x, m),
                          M.make_mesh(4, 1), 0.0),
        "sp4_at1_planes": (lambda m: M.encode_batch_sharded(track, m),
                           M.make_mesh(1, 4), 0.0),
        "sp4_at3_bytes": (lambda m: M.encode_batch_at3_bytes_sharded(
            track, m), M.make_mesh(1, 4), 0.0),
        "m22_at3_js_bytes": (lambda m: M.encode_batch_at3_bytes_sharded(
            pcm, m, js=True, frame_bytes=192), M.make_mesh(2, 2), 0.0),
        "m22_at3p_core": (at3p_core, M.make_mesh(2, 2), 0.0),
        # raw conv floats shift by ulps with the local batch size
        # (parallel/mesh.decode_batch_at1_sharded)
        "m22_at1_decode": (at1_decode, M.make_mesh(2, 2), 1e-6),
    }
    # every sharded call and its one-device reference compile concurrently
    jobs = {}
    for name, (fn, mesh, _) in checks.items():
        jobs[name] = lambda fn=fn, mesh=mesh: timed(fn, mesh)
        jobs[name + "/one"] = lambda fn=fn: timed(fn, one)
    res = _parallel(jobs)
    figs = {}
    for name, (_, _, tol) in checks.items():
        (out, t_sh), (ref, t_one) = res[name], res[name + "/one"]
        figs[name] = {"max_dev": dev_of(out, ref, tol), "sharded_s": t_sh,
                      "one_device_s": t_one}
    return figs


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    dev = devs[0]
    need = 4 if args.four else 1
    if dev.platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} GPU(s); JAX found "
              f"{len(devs)} {dev.platform} device(s)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    import bench

    cache = enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_compile)
    print(f"device: {dev.device_kind} x{len(devs)} ({dev.platform}); "
          f"compile cache {cache}", flush=True)
    print("nvidia-smi:", bench.nvidia_smi_line(), flush=True)

    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx = {"dev": dev, "work": work}
    # groups run one after another; the phases of a group concurrently
    if args.four:
        phases = [[("mesh", phase_mesh)]]
    else:
        phases = [[("kernels", phase_kernels)],
                  [("golden", phase_golden), ("cli", phase_cli),
                   ("transcode", phase_transcode), ("batch", phase_batch)],
                  [("batch_rate", phase_batch_rate)],
                  [("chip_tests", phase_chip_tests)]]
    failed = []
    try:
        results = {}

        def run(name, fn):
            _PHASE.name = name
            t0 = time.perf_counter()
            try:
                figs, status = fn(ctx), "ok"
            except Exception as exc:                 # report, go on
                traceback.print_exc()
                figs, status = {"error": repr(exc)[:400]}, "FAIL"
            results[name] = (status, time.perf_counter() - t0, figs)

        for group in phases:
            threads = [threading.Thread(target=run, args=p) for p in group]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for name, _ in group:
                status, wall, figs = results.get(
                    name, ("FAIL", 0.0, {"error": "phase did not end"}))
                if status != "ok":
                    failed.append(name)
                print(f"phase {name}: {status} "
                      f"compile_s={_COMPILE_S[name]:.1f} wall_s={wall:.1f} "
                      f"{json.dumps(figs, default=str)}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
