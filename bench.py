"""Throughput benchmark: VarDCT encode+decode MP/s on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}, where
"device" names the platform, device kind, device count and power limit
the numbers were taken on.

Metric: combined encode+decode megapixels/second at distance=1 on a
Kodak-sized 512x768 image (BASELINE.json config 1), end-to-end including the
host-side histogram quantization and container assembly. The reference
publishes no timings (BASELINE.md — libjxl is invoked through Docker and
never timed), so there is no baseline ratio.

Runs only on a GPU: a CPU run would time XLA's CPU backend, which is not
what anyone deploys, so it stops with an error instead.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Published peaks per JAX device_kind, for the roofline fraction. Source:
# NVIDIA H100 SXM data sheet (dense rates, at the 700 W power limit): 67
# TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3. The codec's
# arithmetic is float32 at Precision.HIGHEST and mostly elementwise, scan
# or scatter work, so the binding roof is bytes over bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    """Peak rates of a device; a device missing from PEAKS is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}: add its "
            "data-sheet rates to bench.PEAKS"
        ) from None


def _cost_analysis(fn, *args, **kw):
    """(flops, bytes accessed) from XLA's compiled cost model."""
    c = fn.lower(*args, **kw).compile().cost_analysis()
    if isinstance(c, (list, tuple)):
        c = c[0]
    return float(c["flops"]), float(c["bytes accessed"])


def device_info() -> dict:
    """platform / kind / count of JAX's devices plus the card's name and
    power limit from nvidia-smi (printed beside every number)."""
    import jax

    d = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {
        "platform": d[0].platform,
        "kind": d[0].device_kind,
        "count": len(d),
        "nvidia_smi": smi,
    }


def synth_kodak(h=512, w=768, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.55 + 0.25 * np.sin(xx / 41.0) * np.cos(yy / 29.0) + 0.1 * np.sin((xx + yy) / 97.0)
    tex = rng.normal(0, 0.025, (h, w)).astype(np.float32)
    edges = 0.15 * (((xx // 96).astype(np.int32) ^ (yy // 64).astype(np.int32)) % 2)
    lum = np.clip(base + tex + edges, 0, 1)
    rgb = np.stack(
        [lum * (0.85 + 0.15 * np.sin(yy / 83.0)), lum, lum * (0.75 + 0.25 * np.cos(xx / 71.0))],
        axis=-1,
    )
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def load_bench_image():
    """Prefer a real test image if one exists, else synthetic Kodak-like."""
    for root in ("test_images/kodak", "test_images"):
        if os.path.isdir(root):
            for f in sorted(os.listdir(root)):
                if f.lower().endswith((".png", ".ppm")):
                    from jxl_jax.core.io import read_image

                    img = read_image(os.path.join(root, f))
                    if img.shape[0] >= 256 and img.shape[1] >= 256:
                        return img[:512, :768]
    return synth_kodak()


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {jax.devices()[0].platform!r}"
        )
    device = device_info()
    peaks = peaks_for(device["kind"])

    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes, decode_bytes_device
    from jxl_jax.codec.encode import encode_image, encode_images
    from jxl_jax.metrics import calculate_psnr

    # JXL_BENCH_SIZE=HxW overrides the Kodak-sized default (e.g. 2048x2048
    # to measure the throughput scaling with image size).
    size = os.environ.get("JXL_BENCH_SIZE")
    if size:
        h_, w_ = (int(v) for v in size.split("x"))
        img = synth_kodak(h_, w_)
    else:
        img = load_bench_image()
    h, w = img.shape[:2]
    mp = h * w / 1e6
    cfg = CodecConfig(distance=1.0, effort=7)

    from jxl_jax.codec.decode import decode_bytes_grid_stacked
    from jxl_jax.codec.encode import encode_image_grid

    # Warmup / compile
    data = encode_image(img, cfg)
    out = decode_bytes(data)
    psnr = calculate_psnr(img, out)
    bpp = len(data) * 8 / (h * w)

    # Headline throughput: the GRID-BATCHED paths the sweep actually runs —
    # B points per dispatch + ONE transfer each way (the reference's
    # workload is 50 grid points per image, benchmark.rs:637-638), so the
    # per-dispatch and per-transfer costs amortize over B. B = 32: one
    # decode launch then runs the rANS scans of all 32 points side by
    # side. JXL_BENCH_BATCH overrides.
    B = int(os.environ.get("JXL_BENCH_BATCH", "32"))
    dists = [1.0] * B
    from jxl_jax.codec.encode import encode_image_grid_async

    encode_image_grid(img, cfg, dists)  # compile grid programs
    datas = encode_image_grid(img, cfg, dists)  # adopt the history window
    data = datas[-1]

    # Steady-state cadence at pipeline depth 2: row k's fetch + container
    # assembly overlaps row k+1's device compute (what a real sweep
    # sustains row after row); each timed cycle is one full row of B
    # encodes. The priming dispatch and the last finalize both sit INSIDE
    # the timed window.
    #
    # Every wall measurement is the MEDIAN of `reps` independent trials,
    # with the min-max spread reported alongside.
    iters = 6
    reps = int(os.environ.get("JXL_BENCH_REPS", "5"))

    def _enc_trial() -> float:
        t0 = time.perf_counter()
        fin = encode_image_grid_async(img, cfg, dists)
        for _ in range(iters - 1):
            nxt = encode_image_grid_async(img, cfg, dists)
            fin()
            fin = nxt
        fin()
        return (time.perf_counter() - t0) / (iters * B)

    enc_trials = sorted(_enc_trial() for _ in range(reps))
    t_enc = enc_trials[len(enc_trials) // 2]

    outs = decode_bytes_grid_stacked(datas)
    jax.block_until_ready(outs)

    def _dec_trial() -> float:
        # same depth-2 shape: row k+1's host parse + upload overlaps row
        # k's device compute
        t0 = time.perf_counter()
        prev = decode_bytes_grid_stacked(datas)
        for _ in range(iters - 1):
            nxt = decode_bytes_grid_stacked(datas)
            jax.block_until_ready(prev)
            prev = nxt
        jax.block_until_ready(prev)
        return (time.perf_counter() - t0) / (iters * B)

    dec_trials = sorted(_dec_trial() for _ in range(reps))
    t_dec = dec_trials[len(dec_trials) // 2]

    # Single-image pipelined numbers (depth 4) for reference: these pay a
    # dispatch and a transfer per image, as one-off CLI encodes do.
    iters1 = 6
    encode_images([(img, cfg, "")] * 2)  # compile the history-window path
    t0 = time.perf_counter()
    datas1 = encode_images([(img, cfg, "")] * iters1)
    t_enc1 = (time.perf_counter() - t0) / iters1
    t0 = time.perf_counter()
    outs1 = [decode_bytes_device(datas1[-1]) for _ in range(iters1)]
    jax.block_until_ready(outs1)
    t_dec1 = (time.perf_counter() - t0) / iters1

    # Roofline accounting (BASELINE.md: "MP/s at roofline"): XLA's compiled
    # cost model gives FLOPs + HBM bytes for the fused encode and decode
    # programs; the light-speed time is max(flops/peak, bytes/BW) on this
    # device. The Triton decode kernel is a custom call the cost model does
    # not see, so the decode fraction is an UPPER bound on how far from
    # light speed the XLA-visible part runs.
    import jax.numpy as jnp

    from jxl_jax.codec.container import read_container
    from jxl_jax.codec.decode import _pack_stream_np, _pow2_bucket, _decode_packed, _route
    from jxl_jax.codec.encode import (
        _encode_full_pref,
        _first_get_u32,
        pick_lanes,
    )
    from jxl_jax.codec.layout import padded_layout, token_layout
    from jxl_jax.entropy.grouped import MANT_SLACK, WORD_SLACK
    from jxl_jax.entropy.tokens import byte_capacity

    lanes = pick_lanes(token_layout(h, w)["n_tokens"], cfg.lanes)
    lay = padded_layout(h, w, lanes)
    cap = byte_capacity(lay["n_padded"])
    fe, be = _cost_analysis(
        _encode_full_pref,
        jnp.asarray(img),
        jnp.float32(1.0),
        first=_first_get_u32(lanes, h * w),
        height=h,
        width=w,
        effort=7,
        hook_a=False,
        hook_b=False,
        lanes=lanes,
        cap_bytes=cap,
    )
    stream = read_container(data)
    capw = _pow2_bucket(int(stream.wcounts.max()) + WORD_SLACK)
    capm = _pow2_bucket(int(stream.mcounts.max()) + MANT_SLACK)
    fd, bd = _cost_analysis(
        _decode_packed,
        jnp.asarray(_pack_stream_np(stream, capw, capm)),
        jnp.float32(1.0),
        height=h,
        width=w,
        lanes=lanes,
        epf=True,
        capw=capw,
        capm=capm,
        route=_route(),
    )
    peak_flops, peak_bw = peaks["flops"], peaks["hbm_bytes_per_s"]
    enc_min = max(fe / peak_flops, be / peak_bw)
    dec_min = max(fd / peak_flops, bd / peak_bw)

    # DEVICE-COMPUTE roofline: MARGINAL per-image device time, measured as
    # the SLOPE between an 8- and a 16-image single-dispatch run of the
    # same encode/decode programs (distances vary epsilon-wise to prevent
    # loop-invariant hoisting): slope = (t16 - t8) / 8. A single-dispatch
    # total divided by its batch would count the per-DISPATCH fixed cost
    # as device time; the slope cancels it and is what the device
    # sustains per image in a steady stream. The intercept is reported as
    # *_dispatch_fixed_ms so the fixed cost stays visible.
    from jxl_jax.codec.decode import _decode_packed_grid
    from jxl_jax.codec.encode import _encode_full_core

    def _mapped_total_ms(fn_of_d, iters, reps=4):
        dists = jnp.float32(1.0) + jnp.arange(iters, dtype=jnp.float32) * 1e-4
        run = jax.jit(lambda ds: jax.lax.map(fn_of_d, ds))
        jax.block_until_ready(run(dists))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run(dists))
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    imgj = jnp.asarray(img)

    def enc_of_d(d):
        return _encode_full_core(
            imgj, d, height=h, width=w, effort=7, hook_a=False, hook_b=False,
            lanes=lanes, cap_bytes=cap,
        )

    enc_t8 = _mapped_total_ms(enc_of_d, 8)
    enc_t16 = _mapped_total_ms(enc_of_d, 16)
    enc_dev_ms = (enc_t16 - enc_t8) / 8
    enc_fixed_ms = enc_t8 - 8 * enc_dev_ms

    # decode device slope: the grid-batched program (batched rANS kernel)
    # on device-resident 8- and 16-row batches
    dec_kw = dict(
        height=h, width=w, lanes=lanes, epf=True, capw=capw, capm=capm,
        route=_route(),
    )

    def _dec_total_ms(n, reps=4):
        packed_b = jnp.asarray(
            np.stack([_pack_stream_np(stream, capw, capm)] * n)
        )
        dn = jnp.full((n,), 1.0, jnp.float32)
        jax.block_until_ready(_decode_packed_grid(packed_b, dn, **dec_kw))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(_decode_packed_grid(packed_b, dn, **dec_kw))
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    dec_t8 = _dec_total_ms(8)
    dec_t16 = _dec_total_ms(16)
    dec_dev_ms = (dec_t16 - dec_t8) / 8
    dec_fixed_ms = dec_t8 - 8 * dec_dev_ms

    def _slope_fields(dev_ms, fixed_ms, light_s):
        """Guard the slope-derived fields against timing jitter: t16 <= t8
        would yield a junk negative/near-zero slope — report
        nulls instead of nonsense, and clamp the fixed floor at 0."""
        if dev_ms <= 0.05 * light_s * 1e3:
            return None, None, max(fixed_ms, 0.0)
        return round(dev_ms, 3), round(light_s * 1e3 / dev_ms, 4), max(fixed_ms, 0.0)

    enc_dev_ms, enc_dev_frac, enc_fixed_ms = _slope_fields(
        enc_dev_ms, enc_fixed_ms, enc_min
    )
    dec_dev_ms, dec_dev_frac, dec_fixed_ms = _slope_fields(
        dec_dev_ms, dec_fixed_ms, dec_min
    )

    mps = mp / (t_enc + t_dec)
    print(
        json.dumps(
            {
                "metric": "encode+decode MP/s/device (VarDCT d=1)",
                "value": round(mps, 3),
                "unit": "MP/s",
                "device": device,
                "encode_mps": round(mp / t_enc, 3),
                "decode_mps": round(mp / t_dec, 3),
                "encode_mps_single": round(mp / t_enc1, 3),
                "decode_mps_single": round(mp / t_dec1, 3),
                "grid_batch": B,
                # median of `reps` trials; spreads are min-max MP/s across
                # trials for each stage
                "reps": reps,
                "encode_mps_spread": [
                    round(mp / enc_trials[-1], 3),
                    round(mp / enc_trials[0], 3),
                ],
                "decode_mps_spread": [
                    round(mp / dec_trials[-1], 3),
                    round(mp / dec_trials[0], 3),
                ],
                "psnr_db": round(psnr, 2),
                "bpp": round(bpp, 4),
                "roofline": {
                    "peak_flops": peak_flops,
                    "peak_hbm_bw": peak_bw,
                    "encode_gflops": round(fe / 1e9, 2),
                    "encode_hbm_mb": round(be / 1e6, 1),
                    "encode_lightspeed_ms": round(enc_min * 1e3, 3),
                    "encode_roofline_frac": round(enc_min / t_enc, 4) if t_enc else 0,
                    "decode_gflops": round(fd / 1e9, 2),
                    "decode_hbm_mb": round(bd / 1e6, 1),
                    "decode_lightspeed_ms": round(dec_min * 1e3, 3),
                    "decode_roofline_frac": round(dec_min / t_dec, 4) if t_dec else 0,
                    # device-compute fractions: marginal (slope) per-image
                    # device time vs the cost-model lightspeed; the fixed
                    # per-dispatch fixed cost is reported separately
                    "encode_device_ms": enc_dev_ms,
                    "encode_device_frac": enc_dev_frac,
                    "encode_dispatch_fixed_ms": round(enc_fixed_ms, 3),
                    "decode_device_ms": dec_dev_ms,
                    "decode_device_frac": dec_dev_frac,
                    "decode_dispatch_fixed_ms": round(dec_fixed_ms, 3),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
