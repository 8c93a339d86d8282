"""Stage-level encode/decode wall-time profile on the current platform.

Times (jitted, steady-state, pipelined over ITERS calls):
  xyb+blocks | search_acs | tokens_from_rgb (stage 1) | full encode |
  rANS decode kernel | full decode
and prints a table with per-stage ms. Run on the GPU for the real
numbers (the bench image geometry); the decode uses the platform's rANS
route (triton_rans.decode_route).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ITERS = 8


def timeit_mapped(fn_of_d, reps=3):
    """Time a distance-parameterized stage as lax.map over ITERS slightly-
    different distances inside ONE dispatch — the per-dispatch overhead
    amortizes across the batch (same structure the grid-batched bench paths
    use), and the distance variation prevents XLA from hoisting the
    loop-invariant body."""
    import jax
    import jax.numpy as jnp

    dists = jnp.float32(1.0) + jnp.arange(ITERS, dtype=jnp.float32) * 1e-4

    @jax.jit
    def run(ds):
        return jax.lax.map(fn_of_d, ds)

    jax.block_until_ready(run(dists))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(dists))
        best = min(best, (time.perf_counter() - t0) / ITERS * 1e3)
    return best


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from bench import synth_kodak
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.container import read_container
    from jxl_jax.codec.decode import (
        _decode_packed,
        _pack_stream_np,
        _pow2_bucket,
        _route,
    )
    from jxl_jax.codec.encode import (
        _encode_full_pref,
        _first_get_u32,
        encode_image,
        image_to_blocks,
        pick_lanes,
        tokens_from_rgb,
    )
    from jxl_jax.codec.layout import padded_layout, token_layout
    from jxl_jax.core.xyb import srgb_to_xyb
    from jxl_jax.entropy.grouped import MANT_SLACK, WORD_SLACK
    from jxl_jax.entropy.tokens import byte_capacity
    from jxl_jax.strategy.acs import search_acs
    from jxl_jax.transforms.adaptive import qf_multiplier, quant_field

    h, w = 512, 768
    img = jnp.asarray(synth_kodak(h, w))
    effort = int(os.environ.get("PROF_EFFORT", "7"))
    lay = token_layout(h, w)

    @jax.jit
    def stage_xyb(rgb):
        x = rgb.astype(jnp.float32) / 255.0
        xyb = srgb_to_xyb(x)
        planes = jnp.stack([xyb[..., 0], xyb[..., 1], xyb[..., 2] - xyb[..., 1]])
        return image_to_blocks(planes, lay["hp"], lay["wp"])

    @partial(jax.jit, static_argnames=("effort",))
    def stage_acs(rgb, d, *, effort):
        x = rgb.astype(jnp.float32) / 255.0
        xyb = srgb_to_xyb(x)
        planes = jnp.stack([xyb[..., 0], xyb[..., 1], xyb[..., 2] - xyb[..., 1]])
        planes_p = jnp.pad(
            planes,
            ((0, 0), (0, lay["hp"] - h), (0, lay["wp"] - w)),
            mode="edge",
        )
        blocks = image_to_blocks(planes, lay["hp"], lay["wp"])
        qf = qf_multiplier(quant_field(planes_p[1]))
        return search_acs(
            blocks, planes_p, d, effort=effort, hook_a=False, hook_b=False, qf_mul=qf
        )

    stage1 = partial(
        jax.jit, static_argnames=("height", "width", "effort", "hook_a", "hook_b")
    )(tokens_from_rgb)

    lanes = pick_lanes(lay["n_tokens"], 256)
    play = padded_layout(h, w, lanes)
    cap = byte_capacity(play["n_padded"])

    def full_enc(rgb, d):
        return _encode_full_pref(
            rgb,
            d,
            first=_first_get_u32(lanes, h * w),
            height=h,
            width=w,
            effort=effort,
            hook_a=False,
            hook_b=False,
            lanes=lanes,
            cap_bytes=cap,
        )

    t_xyb = timeit_mapped(lambda d: stage_xyb(img + (d * 0).astype(jnp.uint8)))
    t_acs = timeit_mapped(lambda d: stage_acs(img, d, effort=effort))
    t_s1 = timeit_mapped(
        lambda d: tokens_from_rgb(
            img, d, height=h, width=w, effort=effort, hook_a=False, hook_b=False
        )
    )
    from jxl_jax.codec.encode import _encode_full_core

    t_full = timeit_mapped(
        lambda d: _encode_full_core(
            img,
            d,
            height=h,
            width=w,
            effort=effort,
            hook_a=False,
            hook_b=False,
            lanes=lanes,
            cap_bytes=cap,
        )
    )

    data = encode_image(np.asarray(img), CodecConfig(distance=1.0, effort=effort))
    stream = read_container(data)
    capw = _pow2_bucket(int(stream.wcounts.max()) + WORD_SLACK)
    capm = _pow2_bucket(int(stream.mcounts.max()) + MANT_SLACK)
    packed = jnp.asarray(_pack_stream_np(stream, capw, capm))

    from jxl_jax.codec.decode import _decode_packed_core

    t_dec = timeit_mapped(
        lambda d: _decode_packed_core(
            packed,
            d,
            height=h,
            width=w,
            lanes=lanes,
            epf=True,
            capw=capw,
            capm=capm,
            route=_route(),
        )
    )

    print(f"platform={jax.devices()[0].platform} effort={effort} lanes={lanes} "
          f"route={_route()} bpp={len(data)*8/(h*w):.4f}")
    print(f"xyb+blocks      {t_xyb:8.2f} ms")
    print(f"acs search      {t_acs:8.2f} ms   (minus xyb ~{t_acs - t_xyb:.2f})")
    print(f"stage1 tokens   {t_s1:8.2f} ms   (quant+cfl+tok+hist ~{t_s1 - t_acs:.2f})")
    print(f"full encode     {t_full:8.2f} ms   (entropy+pack ~{t_full - t_s1:.2f})")
    print(f"full decode     {t_dec:8.2f} ms")


if __name__ == "__main__":
    main()
