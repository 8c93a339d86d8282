"""Decode kernel vs XLA twin end to end on the GPU, and where the encode and
decode programs spend device time.

Usage: python tools/route_ab.py [--out FILE.json] [--trace-dir DIR]

1. End-to-end decode (host parse + upload + decode + download) with the
   Triton rANS kernel ("triton") and with its XLA scan twin ("xla"), timed
   in turns (kernel, twin, twin, kernel; median of --reps per turn):
     - decode_bytes of a Kodak-shaped 512x768 image at d=1 e7 (lanes 256)
     - decode_bytes_grid_stacked of a 32-point grid row at d=1 e7
     - decode_bytes of a CLIC-sized 2048x1365 image (lanes 512)
2. The rANS stage alone (Kodak image; grid row), by the kernel's
   num_warps.
3. One profiler trace each of the Kodak encode program and decode program:
   device time by named scope (rans_encode_scan, rans_word_scatter,
   mantissa_pack; the rans_decode kernel), read back with
   jax.profiler.ProfileData (`scope_shares`).

Prints one JSON object with the card's name and power limit. Needs a GPU.
"""

import argparse
import glob
import json
import os
import re
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _hlo_scopes(hlo_text: str, scopes) -> dict:
    """HLO instruction name -> the first of `scopes` its op_name metadata
    names (instructions outside every scope are left out)."""
    out = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        for s in scopes:
            if s in m.group(2):
                out[m.group(1)] = s
                break
    return out


def _union_ns(intervals) -> float:
    """Length of the union of [start, end) intervals (nested events, such
    as kernels inside a command buffer, count once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def scope_shares(
    xplane_path: str, hlo_text: str, module: str, scopes, device_prefix: str = "/device:GPU"
) -> dict:
    """Device time of one HLO module's events in a trace: busy time (the
    union of its event intervals), and per named scope the union of the
    events in that scope — found through the compiled module's op_name
    metadata, or through the kernel's own name for custom calls such as
    Pallas kernels.

    Returns {"busy_ns", "by_scope": {scope: ns}, "share": {scope: ns /
    busy}, "top_ops": the 12 largest ops as (name, summed ns, scope)}."""
    from jax.profiler import ProfileData

    names = _hlo_scopes(hlo_text, scopes)
    pd = ProfileData.from_file(xplane_path)
    every, in_scope, by_op = [], {s: [] for s in scopes}, {}
    for plane in pd.planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = {k: v for k, v in ev.stats}
                if module not in str(st.get("hlo_module", "")):
                    continue
                iv = (ev.start_ns, ev.start_ns + ev.duration_ns)
                every.append(iv)
                op = str(st.get("hlo_op", "")) or ev.name
                by_op[op] = by_op.get(op, 0.0) + ev.duration_ns
                scope = names.get(op) or next((s for s in scopes if s in ev.name), None)
                if scope:
                    in_scope[scope].append(iv)
    busy = _union_ns(every)
    by_scope = {s: _union_ns(iv) for s, iv in in_scope.items()}
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    return {
        "busy_ns": busy,
        "by_scope": by_scope,
        "share": {s: (v / busy if busy else 0.0) for s, v in by_scope.items()},
        "top_ops": [(op, ns, names.get(op)) for op, ns in top],
    }


def _median_ms(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from bench import device_info
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.container import read_container
    from jxl_jax.codec.decode import (
        _decode_packed,
        _pack_row,
        _pack_stream_np,
        _pow2_bucket,
        decode_bytes_grid_stacked,
        decode_stream_device,
    )
    from jxl_jax.codec.encode import _encode_full, encode_image, encode_image_grid, pick_lanes
    from jxl_jax.codec.layout import padded_layout, token_layout
    from jxl_jax.entropy.grouped import MANT_SLACK, WORD_SLACK
    from jxl_jax.entropy.tokens import byte_capacity
    from tools.make_test_images import synth_photo

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("route_ab.py measures the GPU")
    result = {"device": device_info()}
    cfg = CodecConfig(distance=1.0, effort=7)
    kodak = synth_photo(512, 768, 0)
    large = synth_photo(1365, 2048, 1)
    d_kodak = encode_image(kodak, cfg)
    d_large = encode_image(large, cfg)
    row = encode_image_grid(kodak, cfg, [1.0] * 32)

    def single(data, route):
        return lambda: np.asarray(decode_stream_device(read_container(data), route=route))

    def grid(datas, route):
        return lambda: np.asarray(jax.device_get(decode_bytes_grid_stacked(datas, route=route)))

    cases = {
        "decode_bytes_kodak_512x768": lambda r: single(d_kodak, r),
        "decode_bytes_grid_stacked_B32": lambda r: grid(row, r),
        "decode_bytes_clic_2048x1365": lambda r: single(d_large, r),
    }
    ab = {}
    for name, make in cases.items():
        fk, fx = make("triton"), make("xla")
        t0 = time.perf_counter()
        fk()
        compile_k = time.perf_counter() - t0
        t0 = time.perf_counter()
        fx()
        compile_x = time.perf_counter() - t0
        turns = {"triton": [], "xla": []}
        for route, f in (("triton", fk), ("xla", fx), ("xla", fx), ("triton", fk)):
            turns[route].append(_median_ms(f, args.reps))
        ab[name] = {
            "kernel_ms": turns["triton"], "twin_ms": turns["xla"],
            "first_call_s": {"triton": compile_k, "xla": compile_x},
            "speedup": statistics.mean(turns["xla"]) / statistics.mean(turns["triton"]),
        }
        print(name, json.dumps(ab[name]), flush=True)
    result["end_to_end"] = ab

    # the rANS stage alone, by warps per program
    from jxl_jax.codec.decode import _rans_values
    from jxl_jax.entropy import triton_rans

    tuning = {}
    for name, datas in (("kodak", [d_kodak]), ("grid_B32", row)):
        packed, _d, kw = _pack_row(datas)
        packed = jnp.asarray(packed)
        for nw in (4, 8, 16):
            f = jax.jit(lambda p, nw=nw: _with_params(
                triton_rans, dict(num_warps=nw), _rans_values, p, kw))
            jax.block_until_ready(f(packed))
            ms = _median_ms(lambda: jax.block_until_ready(f(packed)), args.reps)
            tuning[f"{name} num_warps={nw}"] = ms
            print(name, nw, ms, flush=True)
    result["rans_stage_ms_by_launch_params"] = tuning

    # profiler traces: encode and decode programs of the Kodak image
    h, w = kodak.shape[:2]
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], 256)
    cap = byte_capacity(padded_layout(h, w, lanes)["n_padded"])
    ekw = dict(height=h, width=w, effort=7, hook_a=False, hook_b=False, lanes=lanes, cap_bytes=cap)
    img = jnp.asarray(kodak)
    enc_hlo = _encode_full.lower(img, jnp.float32(1.0), **ekw).compile().as_text()
    stream = read_container(d_kodak)
    capw = _pow2_bucket(int(stream.wcounts.max()) + WORD_SLACK)
    capm = _pow2_bucket(int(stream.mcounts.max()) + MANT_SLACK)
    pk = jnp.asarray(_pack_stream_np(stream, capw, capm))
    dkw = dict(height=h, width=w, lanes=lanes, epf=True, capw=capw, capm=capm, route="triton")
    dec_hlo = _decode_packed.lower(pk, jnp.float32(1.0), **dkw).compile().as_text()
    jax.block_until_ready(_encode_full(img, jnp.float32(1.0), **ekw))
    jax.block_until_ready(_decode_packed(pk, jnp.float32(1.0), **dkw))
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="route_ab_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            jax.block_until_ready(_encode_full(img, jnp.float32(1.0), **ekw))
        for _ in range(3):
            jax.block_until_ready(_decode_packed(pk, jnp.float32(1.0), **dkw))
    xp = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))[-1]
    enc = scope_shares(xp, enc_hlo, "_encode_full", ("rans_encode_scan", "rans_word_scatter", "mantissa_pack"))
    dec = scope_shares(xp, dec_hlo, "_decode_packed", ("rans_decode",))
    result["trace"] = {"xplane": xp, "encode": enc, "decode": dec}
    print("trace", json.dumps(result["trace"]), flush=True)
    out = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)


def _with_params(triton_rans, params, rans_values, packed, kw):
    """_rans_values with the kernel's launch parameters pinned (trace-time
    patch)."""
    orig = triton_rans.decode_grouped_triton

    def patched(*a, **k):
        return orig(*a, **params, **k)

    triton_rans.decode_grouped_triton = patched
    try:
        return rans_values(packed, route="triton", **kw)
    finally:
        triton_rans.decode_grouped_triton = orig


if __name__ == "__main__":
    main()
