"""Modular mode — lossless (d=0) and modular-LOSSY (d>0) coding.

The legacy pipeline's sweep grid includes distance 0.0, which in cjxl terms
selects libjxl's modular lossless coder (`old_test_jxl.py:16-27`). This is
the equivalent here, designed so DECODE stays fully parallel:

- reversible color: YCoCg-R integer lifting (exactly invertible with
  arithmetic shifts; the same family JPEG XL's modular mode uses via RCTs)
- predictor: the UNCLAMPED gradient pred = W + N - NW per plane. libjxl's
  ClampedGradient compresses slightly better but its inverse is an
  inherently sequential wavefront; the unclamped form's inverse is a
  separable 2D prefix sum — two cumsums, perfectly vectorizable
- entropy: the same grouped rANS layer as the lossy path (one context per
  channel), so the Pallas decode kernel serves both modes unchanged

At d=0 everything is int32-exact end to end; tests assert bit-identical
pixels.

MODULAR-LOSSY: libjxl's codec falls back to modular/
predictive tools on sharp synthetic content (text, graphics, hard
diagonals) where a dense-DCT coder buys flat runs and hard edges very
expensively — the reference's codec therefore has no graphics weakness
(`benchmark-jpegxl/Dockerfile:40-43` builds the whole of
libjxl, and `old_test_jxl.py:16-27` sweeps such content). The analog
here: quantize the YCoCg-R planes with a distance-derived integer step
(modular_steps), then run the EXACT lossless machinery — predictor
search, activity conditioning, entropy tail — on the quantized planes.
Closed loop by construction (the predictor operates on what the decoder
reconstructs), per-pixel error bounded by step/2 per channel, and the
step law reaches (1, 1, 1) at d=0 so one traced program serves both the
lossless and the modular-lossy points of an RD sweep. The per-image
VarDCT-vs-modular decision lives in codec.encode (measured container
bytes at the calibrated matched-distortion step law).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from jxl_jax.codec.layout import lossless_layout
from jxl_jax.entropy.tokens import ALPHABET, tokenize, zigzag_map, zigzag_unmap


def _mod_coefs():
    """Step-law coefficients (Y, Co, Cg) of the modular-lossy quantizer:
    step_c = max(1, round(k_c * d^p)). Calibrated on the 12-image corpus
    so modular distortion tracks the VarDCT path's at the same distance
    (tools/modular_calib.py); JXL_JAX_MOD_Q='ky,kc,p' overrides."""
    import os

    v = os.environ.get("JXL_JAX_MOD_Q")
    if v:
        ky, kc, p = (float(x) for x in v.split(","))
        return ky, kc, p
    return 3.6, 5.4, 0.85


def modular_steps(distance):
    """Traced distance scalar -> int32 [3] quantization steps (Y, Co, Cg).

    max(1, round(k * d^p)) per channel: exactly (1, 1, 1) at d <= ~0.15,
    i.e. the lossless operating point — the d=0 sweep rows and the lossy
    modular rows share one compiled program."""
    ky, kc, p = _mod_coefs()
    d = jnp.maximum(jnp.asarray(distance, jnp.float32), 0.0)
    dp = d**p
    raw = jnp.stack([ky * dp, kc * dp, kc * dp])
    return jnp.maximum(jnp.round(raw).astype(jnp.int32), 1)


def ycocg_forward(rgb):
    """u8 [H, W, 3] -> int32 [3, H, W] (Y, Co, Cg). Exactly reversible."""
    x = rgb.astype(jnp.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    return jnp.stack([y, co, cg])


def ycocg_inverse(planes):
    """int32 [3, H, W] -> u8 [H, W, 3]."""
    y, co, cg = planes[0], planes[1], planes[2]
    t = y - (cg >> 1)
    g = cg + t
    b = t - (co >> 1)
    r = b + co
    return jnp.stack([r, g, b], axis=-1).astype(jnp.uint8)


def grad_residual(planes):
    """r = x - W - N + NW per [3, H, W] plane (unclamped gradient)."""
    w = jnp.pad(planes, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
    n = jnp.pad(planes, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
    nw = jnp.pad(planes, ((0, 0), (1, 0), (1, 0)))[:, :-1, :-1]
    return planes - w - n + nw


def grad_reconstruct(res):
    """Inverse of grad_residual: separable 2D prefix sum (exact, int32)."""
    return jnp.cumsum(jnp.cumsum(res, axis=1), axis=2)


def _blockify(res, hp: int, wp: int):
    """[3, h, w] -> 8-padded block-major [3, nbl, 64] (pad residuals 0)."""
    h, w = res.shape[-2:]
    rp = jnp.pad(res, ((0, 0), (0, hp - h), (0, wp - w)))
    return rp.reshape(3, hp // 8, 8, wp // 8, 8).transpose(0, 1, 3, 2, 4).reshape(
        3, (hp // 8) * (wp // 8), 64
    )


def _unblockify(blocks, hp: int, wp: int):
    """Inverse of _blockify (padded planes [3, hp, wp])."""
    return blocks.reshape(3, hp // 8, wp // 8, 8, 8).transpose(
        0, 1, 3, 2, 4
    ).reshape(3, hp, wp)


def ll_step_ctx(lay, q_sorted):
    """[T] per-step contexts: static flag-section prefix + activity-
    conditioned pixel contexts (first-token rule) — the lossless twin of
    encode._step_ctx_v8."""
    static_a = jnp.asarray(lay["step_ctx"][: lay["t_a"]])
    chan = lay["ll_step_chan"].astype(np.int64)
    flat = (chan * lay["nbl"] + lay["ll_step_blk"]).astype(np.int32)
    qs = q_sorted.reshape(-1)[jnp.asarray(flat)]
    base = jnp.asarray((3 + chan).astype(np.int32))
    return jnp.concatenate([static_a, base + qs.astype(jnp.int32) * 3])


def lossless_tokens(rgb, *, height: int, width: int, distance=None, planes=None):
    """Pixels -> (tokens, nbits, mantissa, params, q_sorted).

    distance=None (or a traced 0.0) is the exact lossless mode; a traced
    d>0 quantizes the YCoCg-R planes by modular_steps(d) FIRST and runs
    the identical machinery on the quantized planes (modular-lossy).

    planes (int32 [3, H, W], optional) bypasses the YCoCg transform and
    codes the given planes directly — the palette mode feeds
    [index, 0, 0] here (codec/encode._encode_palette_core): the two zero
    planes collapse into the all-flat activity class and cost ~nothing.

    params (traced uint32): per-channel predictor mode, 2 bits each
    (bits 2c..2c+1 for channel c): 0 = none, 1 = west, 2 = gradient,
    3 = north — chosen per channel on the rate proxy (container flags
    bits 2-7). All four inverses are prefix sums, so decode stays fully
    parallel whatever is picked (north — a column cumsum — wins on
    content with horizontal banding where gradient's unclamped overshoot
    at hard edges explodes the residual range).

    v8: residual planes are 8-padded, split into 8x8 blocks, and each
    (channel, block) signals an activity class (layout.LL_EDGES buckets
    on its nonzero count) in a section decoded before the pixels; the
    pixel contexts condition on it and the block axis sorts by class —
    flat regions then cost ~0.0004 bits/pixel instead of P(zero)-bits.
    """
    from jxl_jax.codec.layout import LL_EDGES, lossless_layout

    if planes is None:
        planes = ycocg_forward(rgb)
    if distance is not None:
        steps = modular_steps(distance)[:, None, None]
        planes = jnp.round(
            planes.astype(jnp.float32) / steps.astype(jnp.float32)
        ).astype(jnp.int32)
    w_ = jnp.pad(planes, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
    n_ = jnp.pad(planes, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
    nw_ = jnp.pad(planes, ((0, 0), (1, 0), (1, 0)))[:, :-1, :-1]
    res_all = jnp.stack(
        [planes, planes - w_, planes - w_ - n_ + nw_, planes - n_]
    )  # [4mode, 3ch, H, W]

    from jxl_jax.codec.encode import _bits_proxy, bucket_perm

    mode_costs = jnp.sum(_bits_proxy(res_all), axis=(2, 3))  # [4mode, 3ch]
    modes = jnp.argmin(mode_costs, axis=0).astype(jnp.uint32)  # [3ch]
    params = modes[0] | (modes[1] << 2) | (modes[2] << 4)
    m = modes[:, None, None]
    res = jnp.where(
        m == 0,
        res_all[0],
        jnp.where(m == 1, res_all[1], jnp.where(m == 2, res_all[2], res_all[3])),
    )

    lay = lossless_layout(height, width, 128)  # geometry only (lanes-free)
    hp, wp, nbl = lay["hp"], lay["wp"], lay["nbl"]
    blocks = _blockify(res, hp, wp)  # [3, nbl, 64]
    nnzb = jnp.sum(blocks != 0, axis=-1).astype(jnp.int32)
    q = jnp.zeros_like(nnzb)
    for e in LL_EDGES:
        q = q + (nnzb >= e).astype(jnp.int32)
    perm = bucket_perm(q, nbl)
    blocks_sorted = jnp.take_along_axis(blocks, perm[:, :, None], axis=1)
    q_sorted = jnp.take_along_axis(q, perm, axis=1)

    values = jnp.concatenate(
        [
            q.reshape(-1).astype(jnp.uint32),  # flag maps, raw
            zigzag_map(blocks_sorted.reshape(3, -1)).reshape(-1),
        ]
    )
    token, nbits, mant = tokenize(values)
    # histograms are computed by the shared entropy tail
    # (encode._entropy_and_pack, stepped over the padded stream)
    return token, nbits, mant, params, q_sorted


def reconstruct_lossless(
    values, params, *, height: int, width: int, distance=None, pal=None
):
    """Decoded value stream -> RGB u8 pixels. params: per-channel
    predictor modes (see lossless_tokens). distance (traced, or None)
    selects dequantization: the prefix-sum reconstruction yields the
    QUANTIZED planes, which are scaled back by modular_steps(distance)
    before the YCoCg inverse (identity at d=0 — exact round trip).

    pal (u8 [256, 3], palette mode): plane 0 carries palette indices
    instead of YCoCg luma — the pixels are one row gather pal[idx]."""
    from jxl_jax.codec.encode import bucket_perm
    from jxl_jax.codec.layout import LL_Q, lossless_layout

    lay = lossless_layout(height, width, 128)
    hp, wp, nbl = lay["hp"], lay["wp"], lay["nbl"]
    params = jnp.asarray(params, jnp.uint32)
    modes = jnp.stack([(params >> (2 * c)) & 3 for c in range(3)]).astype(jnp.int32)
    q = jnp.clip(
        values[: 3 * nbl].astype(jnp.int32).reshape(3, nbl), 0, LL_Q - 1
    )
    perm = bucket_perm(q, nbl)
    inv_perm = jnp.argsort(perm, axis=1)
    blocks_sorted = zigzag_unmap(values[3 * nbl :]).reshape(3, nbl, 64)
    blocks = jnp.take_along_axis(blocks_sorted, inv_perm[:, :, None], axis=1)
    res = _unblockify(blocks, hp, wp)
    rec_w = jnp.cumsum(res, axis=2)
    rec_g = jnp.cumsum(rec_w, axis=1)
    rec_n = jnp.cumsum(res, axis=1)
    m = modes[:, None, None]
    planes = jnp.where(
        m == 0,
        res,
        jnp.where(m == 1, rec_w, jnp.where(m == 2, rec_g, rec_n)),
    )[:, :height, :width]
    if pal is not None:
        idx = jnp.clip(planes[0], 0, 255)
        return pal[idx]
    if distance is not None:
        planes = planes * modular_steps(distance)[:, None, None]
        # quantization can push reconstructed RGB out of [0, 255]; the
        # lifting inverse would wrap on the u8 cast, so clip in RGB space
        # (a no-op for d=0 streams, whose planes invert exactly in range)
        y, co, cg = planes[0], planes[1], planes[2]
        t = y - (cg >> 1)
        g = cg + t
        b = t - (co >> 1)
        r = b + co
        rgbp = jnp.stack([r, g, b], axis=-1)
        return jnp.clip(rgbp, 0, 255).astype(jnp.uint8)
    return ycocg_inverse(planes)
