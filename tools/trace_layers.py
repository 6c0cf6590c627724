"""Device time per encoder layer, from one jax.profiler trace.

Runs one warm call of a batched encode under the profiler and reduces the
trace: each device event names an HLO instruction (`hlo_op`), the compiled
HLO text maps that instruction to its `op_name` metadata, and the
`jax.named_scope` names in the encoders (quant_memo, rate_control,
final_mantissas, ...) are substrings of it.  Busy time is the union of
device event intervals; the idle share is 1 - busy / window, where the
window runs from the first device event to the last.  XLA's command
buffers (CUDA graphs) are turned off for the traced process: inside one,
the trace shows a single `command_buffer` event instead of the kernels.

    python tools/trace_layers.py [--codec at3|at1] [--streams 64]
                                 [--frames 256] [--out chiprun_out/trace]
"""
import argparse
import glob
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SCOPES = ("filterbank", "gain_mdct", "tonal", "scale", "quant_memo",
          "rate_control", "final_mantissas", "pack_device")

_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')


def hlo_scope_map(hlo_text):
    """{instruction name: op_name metadata} over every computation."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xplane_path, op_names, scopes=SCOPES):
    """Per-scope device ns, busy ns, window ns and idle share of the GPU
    planes of one trace file."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    seen = set()
    intervals = []
    by_scope = {s: 0 for s in scopes}
    by_scope["other"] = 0
    kernels = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if not op:
                    continue
                key = (ev.start_ns, op)
                if key in seen:
                    continue
                seen.add(key)
                s, e = int(ev.start_ns), int(ev.end_ns)
                intervals.append((s, e))
                name = op_names.get(op, "")
                hit = next((sc for sc in scopes if sc in name), "other")
                by_scope[hit] += e - s
                kernels[op] = kernels.get(op, 0) + (e - s)
    if not intervals:
        raise RuntimeError(f"no device events in {xplane_path}")
    busy = _union_ns(intervals)
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "device_events": len(intervals),
        "busy_ns": busy,
        "window_ns": window,
        "idle_share": 1.0 - busy / window,
        "scope_ns": by_scope,
        "scope_share": {k: v / max(sum(by_scope.values()), 1)
                        for k, v in by_scope.items()},
        "top_ops": [(op, ns, op_names.get(op, "")[-90:]) for op, ns in top],
    }


def trace_call(fn, x, out_dir):
    """Compile jitted `fn` for `x`, warm it, then trace one call."""
    return trace_compiled(fn.lower(x).compile(), x, out_dir)


def trace_compiled(compiled, x, out_dir):
    """Warm, then trace one call of an AOT-compiled `compiled(x)`."""
    import jax

    op_names = hlo_scope_map(compiled.as_text())
    jax.block_until_ready(compiled(x))
    jax.profiler.start_trace(out_dir)
    jax.block_until_ready(compiled(x))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(
        out_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    return reduce_trace(path, op_names)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--codec", choices=("at3", "at1"), default="at3")
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    import jax.numpy as jnp
    import bench
    from atracdenc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.codec == "at3":
        fn = bench.at3_bytes_batch()
        x = jnp.asarray(bench.make_pcm(args.streams, 1024 * args.frames))
    else:
        fn = bench.at1_batch()
        x = jnp.asarray(bench.make_pcm(args.streams, 512 * args.frames))
    res = trace_call(fn, x, os.path.join(args.out, args.codec))
    print(json.dumps({"codec": args.codec, "streams": args.streams,
                      "frames": args.frames,
                      "nvidia_smi": bench.nvidia_smi_line(), **res}))


if __name__ == "__main__":
    main()
