"""Stage-level codec profiler (consolidates the round-1 scratch scripts).

Usage: python tools/profile_codec.py [HxW]

Times, on the current default device:
  - encoder stage 1 (pixels -> tokens + histograms)
  - grouped rANS encode + mantissa pack (entropy tail)
  - full fused encode program, and pipelined steady state (depth 4)
  - decode (device-resident) and decode reconstruction
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bench import synth_kodak
from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.analysis import encode_tokens_for_analysis
from jxl_jax.codec.decode import decode_bytes_device
from jxl_jax.codec.encode import (
    encode_image,
    encode_images,
    pick_lanes,
)
from jxl_jax.codec.layout import padded_layout, token_layout
from jxl_jax.entropy.grouped import pack_mantissa_grouped, rans_encode_grouped
from jxl_jax.entropy.rans import quantize_histograms
from jxl_jax.entropy.tokens import byte_capacity


def timeit(label, fn, iters=5):
    fn()  # warmup/compile
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"{label:<44} {dt * 1e3:8.2f} ms")
    return dt


def main():
    h, w = 512, 768
    if len(sys.argv) > 1:
        h, w = (int(v) for v in sys.argv[1].split("x"))
    img = synth_kodak(h, w)
    cfg = CodecConfig(distance=1.0, effort=7)
    mp = h * w / 1e6
    print(f"device={jax.devices()[0].platform} image={h}x{w} ({mp:.2f} MP)")

    rgb = jnp.asarray(img)
    stage1 = lambda: encode_tokens_for_analysis(rgb, 1.0, height=h, width=w)
    timeit("stage1: pixels -> tokens+hist", stage1)

    token, nbits, mant, counts = jax.tree_util.tree_map(
        lambda x: jax.block_until_ready(x), stage1()
    )
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], cfg.lanes)
    lay = padded_layout(h, w, lanes)
    cap = byte_capacity(lay["n_padded"])
    freq, cum = quantize_histograms(np.asarray(counts))
    freqj, cumj = jnp.asarray(freq), jnp.asarray(cum)
    n_padded = lay["n_padded"]
    tokp = jnp.zeros((n_padded,), jnp.int32)
    nbp = jnp.zeros((n_padded,), jnp.int32)
    mantp = jnp.zeros((n_padded,), jnp.uint32)
    step_ctx = jnp.asarray(lay["step_ctx"])

    enc = jax.jit(lambda t: rans_encode_grouped(t, step_ctx, freqj, cumj, lanes))
    timeit("rANS encode XLA (grouped scan)", lambda: enc(tokp))
    packf = jax.jit(lambda nb, m: pack_mantissa_grouped(nb, m, lanes, cap))
    timeit("mantissa pack XLA (grouped)", lambda: packf(nbp, mantp))

    from jxl_jax.codec.encode import _encode_full

    kw = dict(
        height=h, width=w, effort=7, hook_a=False, hook_b=False,
        lanes=lanes, cap_bytes=cap,
    )
    timeit("full encode device", lambda: _encode_full(rgb, jnp.float32(1.0), **kw))

    t_full = timeit("full encode (single, incl host)", lambda: encode_image(img, cfg), iters=3)
    jobs = [(img, cfg, "")] * 8
    encode_images(jobs[:2])  # warm
    t0 = time.perf_counter()
    encode_images(jobs)
    t_pipe = (time.perf_counter() - t0) / len(jobs)
    print(f"{'pipelined encode steady state':<44} {t_pipe * 1e3:8.2f} ms  ({mp / t_pipe:.1f} MP/s)")

    data = encode_image(img, cfg)
    t_dec = timeit("decode (device-resident)", lambda: decode_bytes_device(data), iters=5)
    print(f"encode {mp / t_full:.1f} MP/s single, decode {mp / t_dec:.1f} MP/s")


if __name__ == "__main__":
    main()
