"""On-device JXT encoder (fixed 8x8 VarDCT slice — SURVEY §7 M1).

Replaces the reference's `cjxl` invocation path (`docker_manager.rs:100-136`)
with an on-device pipeline:

  sRGB u8 -> XYB -> (B -= Y residual) -> pad -> 8x8 blocks -> DCT
  (matmuls) -> quantize -> DC gradient-predictor residuals + zigzag AC
  (z-major) -> hybrid-uint tokens -> matmul histograms -> K-padded runs ->
  grouped interleaved rANS + grouped mantissa bytes -> one packed u32
  output buffer -> host container assembly.

Device/host split: ALL per-pixel and per-symbol work is one jitted
program; the host does one speculative device_get of the packed prefix and
byte-level container framing — the split SURVEY §7 "hard parts #1"
prescribes, with one device->host transfer per image.

The DC gradient predictor is deliberately unclamped (pred = W + N - NW):
its inverse is a separable 2D prefix sum, so the decoder reconstructs DC
with two cumsums instead of a sequential wavefront.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.container import JxtHeader, JxtStream, write_container
from jxl_jax.codec.layout import (
    CTX_AC_BASE,
    N_CTX,
    NNZ_EDGES,
    NNZ_Q,
    padded_layout,
    token_layout,
)
from jxl_jax.core.xyb import srgb_to_xyb
from jxl_jax.entropy.grouped import (
    GROUP,
    pack_mantissa_grouped,
    rans_encode_grouped,
)
from jxl_jax.entropy.cluster import (
    _entropy_bits,
    cluster_histograms,
    cluster_histograms_kmeans,
)
from jxl_jax.entropy.rans import quantize_histograms_t
from jxl_jax.entropy.tokens import (
    ALPHABET,
    byte_capacity,
    tokenize,
    zigzag_map,
)
from jxl_jax.strategy.acs import search_acs
from jxl_jax.transforms.dct import permute_last
from jxl_jax.transforms.adaptive import qf_multiplier, quant_field
from jxl_jax.transforms.quant import dc_steps_t, dequant_ac_biased


def _ac_deadzone() -> float:
    """Dead-zone width added to the AC zero bin, in step units. Encoder-side
    only (coefficients with |x| < (0.5 + dz) * step code as 0; the decoder
    is unchanged): a slightly wider zero bin buys more rate than the
    distortion it costs on near-threshold noise — the standard dead-zone
    quantizer RD win. Applies to the fast path (effort <= 4); the RDO
    quantizer (effort >= 5, _quantize_ac_rdo) subsumes it by explicitly
    testing the zero candidate. JXL_JAX_DEADZONE overrides."""
    import os

    return float(os.environ.get("JXL_JAX_DEADZONE", "0.12"))


def _rdo_kappa() -> float:
    """Rate weight of the RDO quantizer: candidate cost = (t - recon)^2 +
    kappa * bits, with distortion in step-normalized units — equivalent to
    a per-coefficient Lagrangian lambda = kappa * step^2, the same
    step-proportional lambda classical trellis quantization uses. Tuned on
    the bench set (docs/rd_position.md); JXL_JAX_RDO_KAPPA overrides."""
    import os

    return float(os.environ.get("JXL_JAX_RDO_KAPPA", "0.12"))


def _bits_proxy(q: jnp.ndarray) -> jnp.ndarray:
    """Model-free per-coefficient rate proxy (same family as the ACS
    search's, strategy/acs.py:_rate_bits; fast-log2 — see log2_1p_fast)."""
    from jxl_jax.strategy.acs import log2_1p_fast

    aq = jnp.abs(q).astype(jnp.float32)
    return 2.0 * log2_1p_fast(aq) + 1.1 * (aq > 0)


def _use_clustering() -> bool:
    """Histogram clustering on by default; JXL_JAX_NO_CLUSTER=1 reverts to
    one table per static context (A/B + debugging)."""
    import os

    return not os.environ.get("JXL_JAX_NO_CLUSTER")


def _quantize_ac(x: jnp.ndarray, steps: jnp.ndarray) -> jnp.ndarray:
    """Round-to-nearest with a widened zero bin (see _ac_deadzone)."""
    t = x / steps
    q = jnp.round(t).astype(jnp.int32)
    dz = _ac_deadzone()
    if dz > 0.0:
        q = jnp.where(jnp.abs(t) < 0.5 + dz, 0, q)
    return q


def _quantize_ac_rdo(
    x: jnp.ndarray,
    steps: jnp.ndarray,
    bit_lut: jnp.ndarray | None = None,
    channel: int = 0,
) -> jnp.ndarray:
    """Rate-distortion-optimized AC quantization (effort >= 5).

    Per coefficient, tests the nearest quantization level q0 against its
    toward-zero neighbor q0 - sign(q0) and keeps the one minimizing
    (t - recon(q))^2 + kappa * bits(q), where recon applies the decoder's
    v7 reconstruction bias (transforms/quant.ac_recon_bias) and bits is
    the 2*log2(1+|q|) proxy, or — when the two-pass measured LUT is
    available (effort >= 8) — the coefficient's actual rANS cost under
    the image's own histograms. This is the vectorized, masked-select
    analog of libjxl's per-coefficient quant refinement: every candidate
    for every coefficient at once, no data-dependent control flow.
    """
    from jxl_jax.transforms.quant import ac_recon_bias

    t = x / steps
    q0 = jnp.round(t).astype(jnp.int32)
    q1 = q0 - jnp.sign(q0)
    b = ac_recon_bias()
    kappa = _rdo_kappa()

    def recon(q):
        qf = q.astype(jnp.float32)
        return qf - b * jnp.sign(qf)

    if bit_lut is None:
        b0, b1 = _bits_proxy(q0), _bits_proxy(q1)
    else:
        from jxl_jax.entropy.tokens import ALPHABET, tokenize, zigzag_map

        a = jnp.arange(ALPHABET, dtype=jnp.int32)
        extra = q0.ndim - 2  # axes before the trailing 8x8 storage grid
        lut = bit_lut[channel].reshape((1,) * extra + (8, 8, ALPHABET))

        def bits(q):
            sym, _, _ = tokenize(zigzag_map(q))
            oh = (sym[..., None] == a).astype(jnp.float32)
            return jnp.sum(oh * lut, axis=-1)

        b0, b1 = bits(q0), bits(q1)
    c0 = (t - recon(q0)) ** 2 + kappa * b0
    c1 = (t - recon(q1)) ** 2 + kappa * b1
    return jnp.where(c1 < c0, q1, q0)


def predict_lcol(v: jnp.ndarray) -> jnp.ndarray:
    """Causal 2D prediction of a per-block integer field ([nby, nbx]):
    first column predicts from above, the rest from the left. Residuals
    concentrate near zero (the QF / ACS maps are locally constant), so
    they entropy-code far below the raw values. Inverse:
    codec.decode.unpredict_lcol (two cumsums — no sequential wavefront)."""
    v = v.astype(jnp.int32)
    left = jnp.pad(v, ((0, 0), (1, 0)))[:, :-1]
    up = jnp.pad(v, ((1, 0), (0, 0)))[:-1, :]
    pred = left.at[:, 0].set(up[:, 0])
    return v - pred


def image_to_blocks(planes: jnp.ndarray, hp: int, wp: int) -> jnp.ndarray:
    """[3, H, W] -> edge-padded [3, nby, nbx, 8, 8]."""
    h, w = planes.shape[-2:]
    planes = jnp.pad(planes, ((0, 0), (0, hp - h), (0, wp - w)), mode="edge")
    nby, nbx = hp // 8, wp // 8
    return planes.reshape(3, nby, 8, nbx, 8).transpose(0, 1, 3, 2, 4)


def dc_predict_residual(dcq: jnp.ndarray) -> jnp.ndarray:
    """r = q - W - N + NW over [3, nby, nbx] (unclamped gradient predictor)."""
    w = jnp.pad(dcq, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
    n = jnp.pad(dcq, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
    nw = jnp.pad(dcq, ((0, 0), (1, 0), (1, 0)))[:, :-1, :-1]
    return dcq - w - n + nw


def tokens_from_rgb(
    rgb: jnp.ndarray,
    distance=1.0,
    *,
    height: int,
    width: int,
    effort: int = 7,
    hook_a: bool = False,
    hook_b: bool = False,
):
    """Pixels -> (tokens, nbits, mantissa, histogram counts, dc_mode).

    Pure/traceable (no jit): also the vmap/shard_map building block of the
    distributed batch encoder (jxl_jax.distributed.sharded).

    Runs the full VarDCT path: XYB, AC-strategy search over variable block
    sizes (strategy/acs.py), strategy-dependent RDO quantization, adaptive
    DC prediction, causal QF/ACS map prediction, tokenization.
    effort/hook_a/hook_b gate the search per CodecConfig (SURVEY §2.4
    activation matrix).

    Effort ladder (every legacy-grid effort row is a distinct operating
    point, `old_test_jxl.py:16-27`):
      e1: fixed 8x8, no CfL / adaptive quant, fixed gradient DC predictor
      e2: + adaptive DC predictor search (none / west / gradient)
      e3: + chroma-from-luma + adaptive quant field
      e4: + sub-8x8 AC-strategy search
      e5: + RDO quantization (proxy rate)
      e6/e7: + 16x16 / 32-64 merge ladder rungs (strategy/acs.MERGE_LADDER)
      e8: + two-pass measured-rate ACS search and RDO
      e9: + 128/256 ladder rungs

    `distance` is a TRACED scalar: one compiled encoder serves every
    distance of an RD sweep (the step tables are recomputed on device per
    call — they are tiny).

    dc_mode (traced uint32 scalar, 0=none / 1=west / 2=gradient) is
    signaled in the container flags (bits 2-3) so the decoder picks the
    matching prefix-sum inverse. Adaptive choice matters: on noisy content
    the DC plane is iid-ish and the gradient predictor DOUBLES the
    residual stddev vs no prediction; on smooth content gradient wins.
    """
    lay = token_layout(height, width)
    img = rgb.astype(jnp.float32) / 255.0
    xyb = srgb_to_xyb(img)  # [H, W, 3]
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    planes = jnp.stack([x, y, b - y])  # B coded as residual vs luma
    h0, w0 = planes.shape[-2:]
    planes_p = jnp.pad(
        planes, ((0, 0), (0, lay["hp"] - h0), (0, lay["wp"] - w0)), mode="edge"
    )

    blocks = image_to_blocks(planes, lay["hp"], lay["wp"])

    use_aq = effort >= 3
    use_cfl = effort >= 3
    use_rdo = effort >= 5
    dc_search = effort >= 2
    nby, nbx = lay["nby"], lay["nbx"]

    if use_aq:
        # adaptive quantization: masking-driven per-block multiplier, signaled
        qf_idx = quant_field(planes_p[1])  # [nby, nbx] int32
    else:
        from jxl_jax.transforms.adaptive import QF_CENTER_IDX

        qf_idx = jnp.full((nby, nbx), QF_CENTER_IDX, jnp.int32)
    qf_mul = qf_multiplier(qf_idx)

    def one_pass(bit_lut):
        acs, raw, qsteps = search_acs(
            blocks,
            planes_p,
            distance,
            effort=effort,
            hook_a=hook_a,
            hook_b=hook_b,
            qf_mul=qf_mul,
            bit_lut=bit_lut,
        )

        def quant(x, steps, channel=0):
            if use_rdo:
                return _quantize_ac_rdo(x, steps, bit_lut=bit_lut, channel=channel)
            return _quantize_ac(x, steps)

        # Chroma-from-luma: per-32x32-tile least-squares factors of the X
        # and B-residual coefficients against the *dequantized* luma
        # coefficients (so encoder and decoder see identical predictors),
        # signaled as 1/32-step indices. The (0,0) slots are zero in every
        # strategy, so DC never leaks through the predictor.
        qy = quant(raw[1], qsteps[1], channel=1)
        yd = dequant_ac_biased(qy, qsteps[1])  # decoder-matched luma
        ty, tx = lay["ty"], lay["tx"]

        if use_cfl:

            def tile_sum(x):
                xp = jnp.pad(
                    x, ((0, ty * 4 - nby), (0, tx * 4 - nbx), (0, 0), (0, 0))
                )
                return xp.reshape(ty, 4, tx, 4, 8, 8).sum(axis=(1, 3, 4, 5))

            den = tile_sum(yd * yd) + 1e-9
            cfl_idx = []
            resids = {}
            for c in (0, 2):
                k = jnp.clip(tile_sum(raw[c] * yd) / den, -1.0, 1.0)
                idx = jnp.round(k * 32.0).astype(jnp.int32)
                kq = idx.astype(jnp.float32) / 32.0
                kb = jnp.repeat(jnp.repeat(kq, 4, axis=0), 4, axis=1)[:nby, :nbx]
                resids[c] = raw[c] - kb[:, :, None, None] * yd
                cfl_idx.append(idx.reshape(-1))
        else:
            cfl_idx = [jnp.zeros((ty * tx,), jnp.int32) for _ in range(2)]
            resids = {0: raw[0], 2: raw[2]}

        qx = quant(resids[0], qsteps[0], channel=0)
        qb = quant(resids[2], qsteps[2], channel=2)
        qstorage = jnp.stack([qx, qy, qb])

        # DC plane: exact 8x8 block means * 8 for every strategy.
        dc_step = dc_steps_t(distance)
        dc8 = jnp.mean(blocks, axis=(-2, -1)) * 8.0  # [3, nby, nbx]
        dcq = jnp.round(dc8 / dc_step[:, None, None]).astype(jnp.int32)
        if dc_search:
            # Adaptive DC predictor: residual fields under all three modes,
            # per-image argmin on the rate proxy, masked select (no
            # data-dependent control flow under jit).
            w_ = jnp.pad(dcq, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]
            n_ = jnp.pad(dcq, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
            nw_ = jnp.pad(dcq, ((0, 0), (1, 0), (1, 0)))[:, :-1, :-1]
            res_all = jnp.stack([dcq, dcq - w_, dcq - w_ - n_ + nw_])
            mode_costs = jnp.sum(_bits_proxy(res_all), axis=(1, 2, 3))
            dc_mode = jnp.argmin(mode_costs).astype(jnp.uint32)
            dc_res = jnp.where(
                dc_mode == 0,
                res_all[0],
                jnp.where(dc_mode == 1, res_all[1], res_all[2]),
            )
        else:
            dc_mode = jnp.uint32(2)
            dc_res = dc_predict_residual(dcq)

        ac_zz = permute_last(qstorage.reshape(3, lay["nb"], 64), lay["zigzag"])[..., 1:]

        def map_field(v):
            """Per-block map coding: causal L-column residuals when they
            proxy-cost less than the raw ids (per-image traced choice —
            smooth maps compress as residuals, noisy ones as raw values).
            Returns (tokens u32, on_flag u32)."""
            raw = v.reshape(-1).astype(jnp.uint32)
            res = zigzag_map(predict_lcol(v).reshape(-1))
            on = jnp.sum(_bits_proxy(res)) < jnp.sum(_bits_proxy(raw))
            return jnp.where(on, res, raw), on.astype(jnp.uint32)

        acs_tok, acs_on = map_field(acs)
        qf_tok, qf_on = map_field(qf_idx)

        # --- nnz-bucket conditioning (container v8) ---
        # Per-(channel, block) nonzero-count bucket; the AC histograms
        # condition on it (contexts = channel x zigzag position x bucket).
        # The ENCODER measures on its own exact histograms whether the
        # conditioning pays (it loses when the AC payload is small and the
        # map's signaling cost dominates — high distances, tiny images)
        # and writes a ZERO map when it does not: the decoder simply
        # conditions on whatever map it decodes, so no extra flag bit.
        nb = lay["nb"]
        nnz = jnp.sum(ac_zz != 0, axis=-1).astype(jnp.int32)  # [3, nb]
        qb = jnp.zeros_like(nnz)
        for e in NNZ_EDGES:
            qb = qb + (nnz >= e).astype(jnp.int32)
        av = zigzag_map(ac_zz)  # [3, nb, 63] u32
        ac_tok_ids, _, _ = tokenize(av)
        counts4 = _ac_counts4(ac_tok_ids, qb)  # [3, 63, Q, A]
        h_cond = jnp.sum(_entropy_bits(counts4.astype(jnp.float32)))
        h_marg = jnp.sum(_entropy_bits(counts4.sum(axis=2).astype(jnp.float32)))
        # signaling cost if conditioned: cheaper of raw / causal-residual
        # map coding, measured as exact entropy (alphabet is tiny)
        qmap = qb.reshape(3, nby, nbx)
        qres = zigzag_map(
            jnp.stack([predict_lcol(qmap[c]) for c in range(3)]).reshape(3, -1)
        ).astype(jnp.int32)

        def _small_hist_bits(v, levels):
            oh = (v[..., None] == jnp.arange(levels)[None, None, :]).astype(
                jnp.float32
            )
            return jnp.sum(_entropy_bits(jnp.sum(oh, axis=1)))

        sig_raw = _small_hist_bits(qb, NNZ_Q)
        sig_res = _small_hist_bits(qres, 2 * NNZ_Q)
        sig = jnp.minimum(sig_raw, sig_res)
        # margin covers cluster-header growth + table-quantization slack
        nnz_cond_on = (h_cond + sig + _nnz_margin_bits()) < h_marg
        if _nnz_force() is not None:
            nnz_cond_on = jnp.bool_(_nnz_force())
        q_final = jnp.where(nnz_cond_on, qb, 0)

        # nnz map section tokens: one causal-prediction flag shared by the
        # three channels (params bit 4)
        nnz_res = zigzag_map(
            jnp.stack(
                [predict_lcol(q_final.reshape(3, nby, nbx)[c]) for c in range(3)]
            ).reshape(-1)
        )
        nnz_raw = q_final.reshape(-1).astype(jnp.uint32)
        nnz_on = jnp.sum(_bits_proxy(nnz_res)) < jnp.sum(_bits_proxy(nnz_raw))
        nnz_tok = jnp.where(nnz_on, nnz_res, nnz_raw)

        # stable bucket sort of the block axis (identical on the decoder:
        # keys are distinct, so the order is unique regardless of backend)
        perm = bucket_perm(q_final, nb)
        av_sorted = jnp.take_along_axis(av, perm[:, :, None], axis=1)
        q_sorted = jnp.take_along_axis(q_final, perm, axis=1)

        # 6-bit coding-mode field (container flags bits 2-7): bits 0-1 dc
        # predictor, bit 2 acs-map pred, bit 3 qf-map pred, bit 4 nnz-map pred
        params = dc_mode | (acs_on << 2) | (qf_on << 3) | (nnz_on.astype(jnp.uint32) << 4)

        values = jnp.concatenate(
            [
                acs_tok,
                qf_tok,
                zigzag_map(jnp.concatenate(cfl_idx)),
                nnz_tok,
                zigzag_map(dc_res.reshape(-1)),
                # z-major ([3, 63, nb]) over the bucket-SORTED block axis:
                # contexts form long contiguous runs, the property the
                # grouped rANS layer requires (layout.py).
                av_sorted.transpose(0, 2, 1).reshape(-1),
            ]
        )
        token, nbits, mant = tokenize(values)
        return token, nbits, mant, params, q_sorted, counts4, values

    token, nbits, mant, params, q_sorted, counts4, values = one_pass(None)
    if effort >= 8:
        # TWO-PASS rate model (cjxl's higher efforts analog): re-run the
        # AC-strategy search AND the RDO quantizer with MEASURED per-symbol
        # rANS bit costs from the first pass's own histograms instead of
        # the 2*log2(1+|q|) proxy — merge/split and per-coefficient
        # decisions then optimize the image's actual coded size. e8 and e9
        # therefore produce different (better-RD) bitstreams than e7 even
        # where the transform ladders agree.
        token, nbits, mant, params, q_sorted, counts4, values = one_pass(
            _bits_lut_grid(counts4.sum(axis=2))
        )

    if effort >= 3:
        # Adaptive EPF signaling: the round-3 A/B
        # (docs/epf_ab.md) showed EPF HURTS some content at low distance,
        # yet the flag was set unconditionally. The encoder now runs the
        # real decode-side reconstruction on its own token stream (the
        # dense IDCT path costs ~0.1 ms), applies EPF, and signals whether
        # the filtered planes are actually closer to the source (XYB MSE,
        # quant-step-weighted so chroma's tiny numeric range still counts).
        # params bit 5 -> container flags bit 7; the host ANDs it with
        # config.epf into the decoder-visible EPF bit.
        from jxl_jax.codec.decode import _reconstruct
        from jxl_jax.core.xyb import xyb_to_srgb
        from jxl_jax.transforms.epf import epf_apply

        # encoder params (bits: 0-1 dc, 2 acs, 3 qf, 4 nnz) -> the decoder's
        # layout (bits: 0-1 dc, 2 BIAS, 3 acs, 4 qf, 5 nnz) — mirror of
        # container.JxtHeader.decode_params
        pu = jnp.asarray(params, jnp.uint32)
        dec_params = (
            (pu & 3)
            | jnp.uint32(0b100)
            | (((pu >> 2) & 1) << 3)
            | (((pu >> 3) & 1) << 4)
            | (((pu >> 4) & 1) << 5)
        )
        # skip_merged: 16x16+ regions reconstruct as their sub-8 slots in
        # the DECISION's reconstruction only — merged transforms live on
        # smooth content where the EPF delta is tiny, and dropping the
        # dense overlay ladder from the fused encoder saves device time
        rec_planes, eff_mul = _reconstruct(
            values, distance, dec_params, height=height, width=width,
            epf=False, return_planes=True, skip_merged=True,
        )
        filtered = epf_apply(rec_planes, eff_mul, distance)

        # 2x2 mean-pool before the colorspace tail: the binary comparison
        # has the same sign on pooled pixels (EPF deltas are spatially
        # dense) and pooling is a fused reduction — a ::2 strided slice
        # here would trigger the minor-dim relayout penalty instead
        # (ROADMAP "profiling facts").
        h2, w2 = (height // 2) * 2, (width // 2) * 2

        def pool(p):
            return p[:, :h2, :w2].reshape(3, h2 // 2, 2, w2 // 2, 2).mean(
                axis=(2, 4)
            )

        img_pooled = pool(img.transpose(2, 0, 1)).transpose(1, 2, 0)

        def rgb_err(p):
            # same colorspace tail as the decoder, same domain as the
            # harness's PSNR — the decision criterion IS the metric
            q = pool(p)
            srgb = xyb_to_srgb(jnp.stack([q[0], q[1], q[2] + q[1]], axis=-1))
            return jnp.sum((srgb - img_pooled) ** 2)

        # require a 0.4% relative SSE win before turning the filter on:
        # covers the pooled/skip_merged approximation error so near-ties
        # (like the noisy bench image at d=1, where full-resolution EPF
        # measures -0.011 dB) resolve to OFF rather than flipping on
        # approximation noise
        epf_bit = (rgb_err(filtered) < 0.996 * rgb_err(rec_planes)).astype(
            jnp.uint32
        )
    else:
        epf_bit = jnp.uint32(1)
    force = _epf_force()
    if force is not None:
        epf_bit = jnp.uint32(1 if force else 0)
    params = params | (epf_bit << 5)
    return token, nbits, mant, params, q_sorted


# Token-chunk size for the histogram one-hot matmuls: bounds the one-hot
# operands so gigapixel token streams (51M tokens at 4096x4096) don't
# materialize a multi-GB intermediate. Common image sizes stay
# single-chunk (identical program to the unchunked form).
HIST_CHUNK = 4 * 1024 * 1024
AC_CHUNK_B = 8192  # block-axis chunk for the [3, 63, Q, A] decision counts


def _nnz_margin_bits() -> float:
    """Hysteresis for the nnz-conditioning decision: the measured entropy
    win must exceed this to turn the map on (covers cluster-header growth,
    12-bit table quantization slack, and boundary-step context mismatch —
    all absent from the exact-entropy comparison). JXL_JAX_NNZ_MARGIN
    overrides; JXL_JAX_NNZ_FORCE=0/1 pins the decision for A/B runs."""
    import os

    return float(os.environ.get("JXL_JAX_NNZ_MARGIN", "768"))


def _nnz_force():
    import os

    v = os.environ.get("JXL_JAX_NNZ_FORCE")
    return None if v is None or v == "" else bool(int(v))


def _epf_force():
    """Pin the adaptive-EPF decision (JXL_JAX_EPF_FORCE=0/1) for A/B runs
    (tools/epf_ab.py) and tests; read at trace time like every JXL_JAX_*
    knob (transforms/quant.py docstring)."""
    import os

    v = os.environ.get("JXL_JAX_EPF_FORCE")
    return None if v is None or v == "" else bool(int(v))


def _histogram_mxu(token: jnp.ndarray, ctx_np: np.ndarray, n_ctx: int) -> jnp.ndarray:
    """Per-context histogram as a one-hot matmul instead of a scatter-add
    into the bins. bf16
    0/1 inputs with f32 accumulation are exact below 2^24 counts — each
    chunk contributes at most HIST_CHUNK (= 2^22) to a bin, so the per-
    chunk dot is exact; cross-chunk accumulation is int32 so gigapixel
    streams (51M tokens at 4096x4096, where one dominant (ctx, token) bin
    can exceed 2^24) stay exact too. Used by the small-context paths
    (lossless mode); the v8 lossy path uses _histogram_stepped."""
    n = token.shape[0]
    counts = jnp.zeros((n_ctx, ALPHABET), jnp.int32)
    for s in range(0, n, HIST_CHUNK):
        e = min(s + HIST_CHUNK, n)
        ctx_c = jnp.asarray(ctx_np[s:e])
        ctx_oh = (ctx_c[None, :] == jnp.arange(n_ctx)[:, None]).astype(jnp.bfloat16)
        tok_oh = (token[s:e, None] == jnp.arange(ALPHABET)[None, :]).astype(
            jnp.bfloat16
        )
        counts = counts + jnp.dot(
            ctx_oh, tok_oh, preferred_element_type=jnp.float32
        ).astype(jnp.int32)
    return counts


def _histogram_stepped(
    tokp: jnp.ndarray, step_ctx: jnp.ndarray, lanes: int, n_ctx: int
) -> jnp.ndarray:
    """Exact per-context histogram of a PADDED stream whose context is
    constant within each K-token step (the v8 coding contract, mismatch
    steps included — the tables must describe what actually gets coded).

    Factored two-stage form: per-step symbol histograms first (a fused
    compare+reduce over the lane axis; counts <= lanes), then a tiny
    [T, n_ctx] one-hot matmul folds steps into contexts — ~130 MB of
    traffic at 1.2M tokens instead of the [n, n_ctx] one-hot a generic
    scatter-free histogram would materialize (1.8 GB at n_ctx = 765)."""
    T = tokp.shape[0] // lanes
    tok2 = tokp.reshape(T, lanes)
    counts = jnp.zeros((n_ctx, ALPHABET), jnp.int32)
    tchunk = max(1, HIST_CHUNK // lanes)
    for s in range(0, T, tchunk):
        e = min(s + tchunk, T)
        t = tok2[s:e]
        step_hist = jnp.sum(
            (t[:, :, None] == jnp.arange(ALPHABET)[None, None, :]).astype(jnp.int32),
            axis=1,
        ).astype(jnp.float32)  # [tc, A], entries <= lanes
        ctx_oh = (step_ctx[s:e, None] == jnp.arange(n_ctx)[None, :]).astype(
            jnp.float32
        )
        counts = counts + jnp.dot(
            ctx_oh.T,
            step_hist,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.int32)
    return counts


def _ac_counts4(ac_tok: jnp.ndarray, qb: jnp.ndarray) -> jnp.ndarray:
    """[3, 63, NNZ_Q, A] AC token counts by (channel, position, bucket) —
    the nnz-conditioning decision statistic. Factored einsum over the
    block axis (chunked): exact (0/1 bf16 one-hots, f32 accumulation,
    per-chunk sums <= AC_CHUNK_B < 2^24; cross-chunk int32)."""
    nb = ac_tok.shape[1]
    out = jnp.zeros((3, 63, NNZ_Q, ALPHABET), jnp.int32)
    for s in range(0, nb, AC_CHUNK_B):
        e = min(s + AC_CHUNK_B, nb)
        t = ac_tok[:, s:e]  # [3, cb, 63]
        oh_a = (t[..., None] == jnp.arange(ALPHABET)[None, None, None, :]).astype(
            jnp.bfloat16
        )
        oh_q = (qb[:, s:e, None] == jnp.arange(NNZ_Q)[None, None, :]).astype(
            jnp.bfloat16
        )
        out = out + jnp.einsum(
            "cbq,cbpa->cpqa", oh_q, oh_a, preferred_element_type=jnp.float32
        ).astype(jnp.int32)
    return out


def ac_step_ctx(lay, q_sorted: jnp.ndarray) -> jnp.ndarray:
    """[T - t_a] per-AC-step context ids: the nnz-conditioned (channel,
    position, bucket) of each step's FIRST token (layout.py rationale).
    Everything is static except one tiny gather of the sorted bucket map.
    Shared encoder/decoder ground truth — the decoder recomputes this from
    the DECODED nnz map between its two scan phases."""
    chan = lay["ac_step_chan"].astype(np.int64)
    pos = lay["ac_step_pos"].astype(np.int64)
    # bucket-major ids: base is the bucket-0 id; each bucket adds 3*63
    base = (CTX_AC_BASE + chan * 63 + (pos - 1)).astype(np.int32)
    flat_idx = (chan * lay["nb"] + lay["ac_step_blk"]).astype(np.int32)
    qs = q_sorted.reshape(-1)[jnp.asarray(flat_idx)]
    return jnp.asarray(base) + qs.astype(jnp.int32) * (3 * 63)


def bucket_perm(q_final: jnp.ndarray, nb: int) -> jnp.ndarray:
    """[3, nb] stable bucket-sort permutation of the block axis — the
    shared encoder/decoder block order (keys are distinct, so the result
    is backend-independent)."""
    return jnp.argsort(
        q_final.astype(jnp.int32) * nb + jnp.arange(nb, dtype=jnp.int32)[None, :],
        axis=1,
    )


def _step_ctx_v8(lay, q_sorted: jnp.ndarray) -> jnp.ndarray:
    """[T] per-step context ids: the layout's static ids for phase A plus
    the nnz-conditioned AC ids."""
    static_a = jnp.asarray(lay["step_ctx"][: lay["t_a"]])
    return jnp.concatenate([static_a, ac_step_ctx(lay, q_sorted)])


def _bits_lut_grid(counts_pos: jnp.ndarray) -> jnp.ndarray:
    """[3, 8, 8, A] measured bit cost per (storage position, symbol):
    rANS cost log2(M / freq) under the image's per-position first-pass
    histograms (counts_pos: [3, 63, A], buckets marginalized), plus the
    token's mantissa bits. The (0, 0) slot is never coded (DC plane /
    merged LLF) so its row costs zero."""
    from jxl_jax.entropy.rans import RANS_M, quantize_histograms_t
    from jxl_jax.entropy.tokens import token_nbits
    from jxl_jax.transforms.dct import zigzag_order

    freq, _cum = quantize_histograms_t(counts_pos.reshape(3 * 63, ALPHABET))
    sym_bits = jnp.log2(RANS_M / jnp.maximum(freq.astype(jnp.float32), 1.0))
    sym_bits = sym_bits + token_nbits(jnp.arange(ALPHABET))[None, :].astype(
        jnp.float32
    )  # [3*63, A]
    sym_bits = sym_bits.reshape(3, 63, ALPHABET)

    zz = zigzag_order(8, 8)  # [64] flat index per zigzag position
    inv = np.argsort(zz)  # flat index -> zigzag position
    pos_grid = np.zeros((8, 8), np.int32)  # storage slot -> position-1
    for flat in range(64):
        p = int(inv[flat])
        if p > 0:
            pos_grid[flat // 8, flat % 8] = p - 1
    lut = sym_bits[:, jnp.asarray(pos_grid.reshape(-1))].reshape(3, 8, 8, ALPHABET)
    return lut.at[:, 0, 0, :].set(0.0)


# jitted stage-1 entry for the measurement tools lives in
# jxl_jax.codec.analysis (encode_tokens_for_analysis) — a stable,
# smoke-tested surface instead of a private alias here.


# max signaled cluster tables: the k-means cap (entropy/cluster.py). The
# packed buffer carries CLUSTERED tables + the context->cluster map instead
# of the expanded [n_ctx, A] matrix — at v8's 765 contexts the expansion
# would add ~160 KB to every speculative prefix fetch; clustered form is
# ~8 KB.
K_CLUSTERS = 64


def _cmap_u32(n_ctx: int) -> int:
    return -(-n_ctx // 4)


def _tables_u32(n_ctx: int) -> int:
    return min(K_CLUSTERS, n_ctx) * (-(-ALPHABET // 2))


def _packed_header_u32(lanes: int, n_ctx: int = N_CTX) -> int:
    """u32 slots before the words section: sizes[2] + per-group word and
    mantissa counts[8+8] + params[2] + cmap (4 u8/u32) + cluster tables
    (2 u16/u32) + states[lanes]. params[0] carries the coding-mode word
    (bits 0-1: dc predictor mode); params[1] is reserved."""
    return 20 + _cmap_u32(n_ctx) + _tables_u32(n_ctx) + lanes


def _encode_full_core(
    rgb,
    distance,
    *,
    height: int,
    width: int,
    effort: int,
    hook_a: bool,
    hook_b: bool,
    lanes: int,
    cap_bytes: int,
):
    """The whole encoder as one traceable program: pixels -> ONE packed u32
    buffer whose used prefix holds everything the container needs.

    Each device->host read has a fixed cost, so the encoder packs sizes,
    histogram tables, final states, rANS words (2 per u32) and mantissa
    bytes (4 per u32) into a single buffer; the host fetches one
    size-bounded prefix instead of issuing multiple gets.

    Buffer layout (u32 slots):
      [0] n_words   [1] total mantissa bytes
      [2:10]  per-group word counts   [10:18] per-group mantissa byte counts
      [18 : 18+N_CTX*A]      quantized freq tables
      [.. : ..+lanes]        final rANS states
      [HDR : HDR+ceil(nw/2)] words, 2 x u16 per slot (LE; concatenated
                             per-group consumption-order segments)
      [HDR+ceil(nw/2) : ..]  mantissa bytes, 4 per slot (LE; concatenated
                             per-group segments) — placed at a DYNAMIC
                             offset right after the used words.
    """
    lay = padded_layout(height, width, lanes)
    token, nbits, mant, params, q_sorted = tokens_from_rgb(
        rgb, distance, height=height, width=width, effort=effort, hook_a=hook_a, hook_b=hook_b
    )
    step_ctx = _step_ctx_v8(lay, q_sorted)
    return _entropy_and_pack(
        token, nbits, mant, step_ctx, lay, lanes, cap_bytes, params=params,
    )


# Block-packed section geometry (see _entropy_and_pack): one block is 1024
# u32 slots holding 2048 u16 words (WBLK) or 4096 mantissa bytes (MBLK) in a
# row-permuted order the host inverts with numpy reshapes.
BLK_U32 = 1024
WBLK = 2048
MBLK = 4096


def _pack_u16_blocks(w: jnp.ndarray) -> jnp.ndarray:
    """u16[L] -> u32[ceil(L/2048)*1024]. Block m's u32 (j, l) slot packs
    source elements (m, j, l) | (m, j+8, l) << 16 of the layout-exact
    [m, 16, 128] view — no minor-dim-2 relayout, no tile padding."""
    L = w.shape[0]
    Lp = -(-L // WBLK) * WBLK
    if Lp != L:
        w = jnp.concatenate([w, jnp.zeros((Lp - L,), w.dtype)])
    ws = w.reshape(-1, 16, 128).astype(jnp.uint32)
    return (ws[:, :8] | (ws[:, 8:] << 16)).reshape(-1)


def _pack_u8_blocks(m: jnp.ndarray) -> jnp.ndarray:
    """byte-valued u32[C] -> u32[ceil(C/4096)*1024]. Block m's u32 (j, l)
    slot packs bytes (m, j + 8k, l) << 8k, k = 0..3, of the [m, 32, 128]
    view."""
    C = m.shape[0]
    Cp = -(-C // MBLK) * MBLK
    if Cp != C:
        m = jnp.concatenate([m, jnp.zeros((Cp - C,), m.dtype)])
    ms = m.reshape(-1, 32, 128).astype(jnp.uint32) & jnp.uint32(0xFF)
    return (
        ms[:, :8] | (ms[:, 8:16] << 8) | (ms[:, 16:24] << 16) | (ms[:, 24:32] << 24)
    ).reshape(-1)


def _unpack_u16_blocks_np(sec: np.ndarray, n: int) -> bytes:
    """Host inverse of _pack_u16_blocks: u32[blocks*1024] -> first n u16s
    as little-endian bytes."""
    v = sec.reshape(-1, 8, 128).astype(np.uint32)
    w16 = np.concatenate([v & 0xFFFF, v >> 16], axis=1).astype("<u2").reshape(-1)
    return w16[:n].tobytes()


def _unpack_u8_blocks_np(sec: np.ndarray, n: int) -> bytes:
    """Host inverse of _pack_u8_blocks: u32[blocks*1024] -> first n bytes."""
    v = sec.reshape(-1, 8, 128).astype(np.uint32)
    b = np.concatenate(
        [(v >> (8 * k)) & 0xFF for k in range(4)], axis=1
    ).astype(np.uint8).reshape(-1)
    return b[:n].tobytes()


def _entropy_and_pack(
    token, nbits, mant, step_ctx, lay, lanes: int, cap_bytes: int, params=0,
):
    """Shared tail of every encoder mode (lossy VarDCT and lossless
    modular): K-pad the token stream per the layout's spans, histogram it
    under the per-step contexts, cluster + quantize the tables, entropy-
    code with the grouped rANS, and pack the single output buffer.

    step_ctx: [T] per-step context ids — static for lossless, traced for
    v8 lossy streams (the AC phase conditions on the nnz map). The
    histogram runs over the PADDED stream so padding zeros are charged to
    the contexts that actually code them."""
    n_ctx = lay["n_ctx"]
    n_padded = lay["n_padded"]
    tokp = jnp.zeros((n_padded,), jnp.int32)
    nbp = jnp.zeros((n_padded,), jnp.int32)
    mantp = jnp.zeros((n_padded,), jnp.uint32)
    src = 0
    for _c, dst, n_real, _n_pad in lay["spans"]:
        tokp = jax.lax.dynamic_update_slice(tokp, jax.lax.slice(token, (src,), (src + n_real,)), (dst,))
        nbp = jax.lax.dynamic_update_slice(nbp, jax.lax.slice(nbits, (src,), (src + n_real,)), (dst,))
        mantp = jax.lax.dynamic_update_slice(mantp, jax.lax.slice(mant, (src,), (src + n_real,)), (dst,))
        src += n_real

    step_ctx = jnp.asarray(step_ctx)
    counts = _histogram_stepped(tokp, step_ctx, lanes, n_ctx)
    k_cl = min(K_CLUSTERS, n_ctx)
    if n_ctx > K_CLUSTERS:
        # v8 lossy: 765 contexts — matmul k-means + header-aware greedy merge
        cmap, ctables = cluster_histograms_kmeans(counts, k=k_cl)
    elif _use_clustering():
        # small-context modes (lossless): the exact greedy merge
        merged, cmap = cluster_histograms(counts)
        ctables = merged  # [n_ctx, A]; duplicate rows dedupe at write time
        cmap = jnp.arange(n_ctx, dtype=jnp.int32)
    else:
        ctables = counts
        cmap = jnp.arange(n_ctx, dtype=jnp.int32)
    freqK, _cumK = quantize_histograms_t(ctables)
    freq = freqK[cmap]  # expanded [n_ctx, A] for the coding scan
    cum = jnp.concatenate(
        [jnp.zeros((n_ctx, 1), jnp.uint32), jnp.cumsum(freq, axis=1)[:, :-1]],
        axis=1,
    )
    words, wcounts, states = rans_encode_grouped(tokp, step_ctx, freq, cum, lanes)
    with jax.named_scope("mantissa_pack"):
        mant_arr, mcounts = pack_mantissa_grouped(nbp, mantp, lanes, cap_bytes)
    n_words = jnp.sum(wcounts)
    total_bytes = jnp.sum(mcounts)

    # BLOCK packing (2 u16 / 4 bytes per u32 slot): both sections are
    # stored in 1024-u32 blocks whose halves/quarters are row groups of
    # the natural [*, 8|16|32, 128] view, so the combine is an elementwise
    # shift/or over row slices and no reshape puts a size-2/4 pack axis
    # minor. The host inverts the block permutation with numpy (see
    # _parse_packed).
    w2 = _pack_u16_blocks(words)
    m4 = _pack_u8_blocks(mant_arr)

    G = lanes // GROUP
    counts8 = jnp.zeros((8,), jnp.uint32)
    counts8 = jax.lax.dynamic_update_slice(counts8, wcounts.astype(jnp.uint32), (0,))
    mcounts8 = jnp.zeros((8,), jnp.uint32)
    mcounts8 = jax.lax.dynamic_update_slice(mcounts8, mcounts.astype(jnp.uint32), (0,))

    hdr = _packed_header_u32(lanes, n_ctx)
    # cmap: 4 u8 ids per u32; tables: 2 u16 freqs per u32 (tiny arrays —
    # the relayout cost of these minor-dim packs is irrelevant)
    cmv = cmap.astype(jnp.uint32)
    cpad = _cmap_u32(n_ctx) * 4 - n_ctx
    if cpad:
        cmv = jnp.concatenate([cmv, jnp.zeros((cpad,), jnp.uint32)])
    cmv = cmv.reshape(-1, 4)
    cmap_packed = cmv[:, 0] | (cmv[:, 1] << 8) | (cmv[:, 2] << 16) | (cmv[:, 3] << 24)
    tK = freqK.astype(jnp.uint32)
    if ALPHABET % 2:
        tK = jnp.concatenate([tK, jnp.zeros((k_cl, 1), jnp.uint32)], axis=1)
    tables_packed = (tK[:, 0::2] | (tK[:, 1::2] << 16)).reshape(-1)

    buf = jnp.zeros((hdr + w2.shape[0] + m4.shape[0],), jnp.uint32)
    buf = buf.at[0].set(n_words.astype(jnp.uint32))
    buf = buf.at[1].set(total_bytes.astype(jnp.uint32))
    buf = jax.lax.dynamic_update_slice(buf, counts8, (2,))
    buf = jax.lax.dynamic_update_slice(buf, mcounts8, (10,))
    buf = buf.at[18].set(jnp.asarray(params, jnp.uint32))
    o = 20
    buf = jax.lax.dynamic_update_slice(buf, cmap_packed, (o,))
    o += _cmap_u32(n_ctx)
    buf = jax.lax.dynamic_update_slice(buf, tables_packed, (o,))
    o += _tables_u32(n_ctx)
    buf = jax.lax.dynamic_update_slice(buf, states.astype(jnp.uint32), (o,))
    buf = jax.lax.dynamic_update_slice(buf, w2, (hdr,))
    # mantissa blocks start right after the USED word blocks (block-rounded)
    n_wblk = (n_words.astype(jnp.int32) + WBLK - 1) // WBLK
    buf = jax.lax.dynamic_update_slice(buf, m4, (hdr + n_wblk * BLK_U32,))
    return buf


_encode_full = partial(
    jax.jit,
    static_argnames=(
        "height", "width", "effort", "hook_a", "hook_b", "lanes", "cap_bytes",
    ),
)(_encode_full_core)


def _encode_modular_core(
    rgb, distance, *, height: int, width: int, lanes: int, cap_bytes: int,
):
    """Modular-mode encoder (codec/lossless.py): YCoCg-R planes, quantized
    by modular_steps(distance) (identity at d=0 — true lossless), per-
    channel adaptive predictor residuals through the same grouped entropy
    layer. distance is TRACED: the d=0 and d>0 modular points of an RD
    sweep share one compiled program."""
    from jxl_jax.codec.layout import lossless_layout
    from jxl_jax.codec.lossless import lossless_tokens

    lay = lossless_layout(height, width, lanes)
    token, nbits, mant, params, q_sorted = lossless_tokens(
        rgb, height=height, width=width, distance=distance
    )
    from jxl_jax.codec.lossless import ll_step_ctx

    return _entropy_and_pack(
        token, nbits, mant, ll_step_ctx(lay, q_sorted), lay, lanes, cap_bytes,
        params=params,
    )


@partial(
    jax.jit,
    static_argnames=("height", "width", "lanes", "cap_bytes", "first"),
)
def _encode_modular_pref(rgb, distance, *, first: int, **kw):
    buf = _encode_modular_core(rgb, distance, **kw)
    return jax.lax.slice(buf, (0,), (min(first, buf.shape[0]),)), buf


def _palette_of(rgb: np.ndarray):
    """Palette detection for the lossless path: if the
    image has <= 256 distinct RGB triples (glyph/screenshot content),
    return (palette u8 [N, 3] sorted by luma, index map int32 [H, W]);
    else None. Host-side numpy — one np.unique over packed 24-bit colors.
    Luma-sorting makes the index plane spatially smooth wherever the
    colors are, so the per-channel predictor search still has structure
    to remove."""
    a = np.asarray(rgb)
    if a.ndim != 3 or a.shape[2] != 3:
        return None

    def _pack(x):
        return (
            (x[..., 0].astype(np.uint32) << 16)
            | (x[..., 1].astype(np.uint32) << 8)
            | x[..., 2].astype(np.uint32)
        ).reshape(-1)

    if a.shape[0] * a.shape[1] > (1 << 22):
        # cheap pre-screen before the full-image unique/sort: a stride-4
        # sample already exceeding 256 colors proves the whole image does
        if len(np.unique(_pack(a[::4, ::4]))) > 256:
            return None
    flat = _pack(a)
    colors, inverse = np.unique(flat, return_inverse=True)
    if len(colors) > 256:
        return None
    r = (colors >> 16) & 255
    g = (colors >> 8) & 255
    b = colors & 255
    luma = 0.299 * r + 0.587 * g + 0.114 * b
    order = np.argsort(luma, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    pal = np.stack([r, g, b], axis=1)[order].astype(np.uint8)
    idx = rank[inverse].reshape(a.shape[:2]).astype(np.int32)
    return pal, idx


def _encode_palette_core(idx, *, height: int, width: int, lanes: int, cap_bytes: int):
    """Palette-mode encoder: the luma-sorted index plane rides the modular
    machinery as [idx, 0, 0] (the zero planes collapse into the all-flat
    activity class); the palette itself travels in the container's extra
    section. Lossless by construction."""
    from jxl_jax.codec.layout import lossless_layout
    from jxl_jax.codec.lossless import ll_step_ctx, lossless_tokens

    lay = lossless_layout(height, width, lanes)
    z = jnp.zeros((height, width), jnp.int32)
    planes = jnp.stack([idx.astype(jnp.int32), z, z])
    token, nbits, mant, params, q_sorted = lossless_tokens(
        None, height=height, width=width, planes=planes
    )
    return _entropy_and_pack(
        token, nbits, mant, ll_step_ctx(lay, q_sorted), lay, lanes, cap_bytes,
        params=params,
    )


@partial(jax.jit, static_argnames=("height", "width", "lanes", "cap_bytes", "first"))
def _encode_palette_pref(idx, *, first: int, **kw):
    buf = _encode_palette_core(idx, **kw)
    return jax.lax.slice(buf, (0,), (min(first, buf.shape[0]),)), buf


@partial(
    jax.jit,
    static_argnames=("height", "width", "lanes", "cap_bytes", "first"),
)
def _encode_modular_grid(rgb, distances, *, first: int, **kw):
    """Modular twin of _encode_grid: one dispatch covers a whole RD-sweep
    row's modular-path encodes (lax.map over the traced distance axis)."""
    bufs = jax.lax.map(lambda d: _encode_modular_core(rgb, d, **kw), distances)
    pref = jax.lax.slice(bufs, (0, 0), (bufs.shape[0], min(first, bufs.shape[1])))
    return pref, bufs


@partial(
    jax.jit,
    static_argnames=(
        "height", "width", "effort", "hook_a", "hook_b", "lanes", "cap_bytes", "first",
    ),
)
def _encode_full_pref(rgb, distance, *, first: int, **kw):
    """Encoder returning (speculative prefix, full buffer): the prefix is a
    jit OUTPUT so the host can device_get it the moment it is ready —
    slicing on the host would dispatch a separate op."""
    buf = _encode_full_core(rgb, distance, **kw)
    return jax.lax.slice(buf, (0,), (min(first, buf.shape[0]),)), buf


@partial(
    jax.jit,
    static_argnames=(
        "height", "width", "effort", "hook_a", "hook_b", "lanes", "cap_bytes", "first",
    ),
)
def _encode_grid(rgb, distances, *, first: int, **kw):
    """The full encoder mapped over an RD sweep's distance axis — one
    dispatch covers the whole row of the reference grid (distance is a
    traced scalar throughout the codec, so all lanes share one program).
    lax.map, not vmap: the points run device-sequentially inside one
    compiled program (one dispatch + one batched transfer per row), and
    the body compiles once. Returns (speculative [N, first] prefix, full
    [N, L] buffers)."""
    bufs = jax.lax.map(lambda d: _encode_full_core(rgb, d, **kw), distances)
    pref = jax.lax.slice(bufs, (0, 0), (bufs.shape[0], min(first, bufs.shape[1])))
    return pref, bufs


@partial(
    jax.jit,
    static_argnames=(
        "height", "width", "effort", "hook_a", "hook_b", "lanes", "cap_bytes", "first",
    ),
)
def _encode_imgs(rgbs, distances, *, first: int, **kw):
    """Batch-of-images twin of _encode_grid: lax.map over (image,
    distance) PAIRS, so same-geometry stripes or corpus batches encode in
    ONE dispatch (device-sequential) with one batched transfer each
    way."""
    bufs = jax.lax.map(
        lambda args: _encode_full_core(args[0], args[1], **kw),
        (rgbs, distances),
    )
    pref = jax.lax.slice(bufs, (0, 0), (bufs.shape[0], min(first, bufs.shape[1])))
    return pref, bufs


def encode_images_batched_async(
    rgbs, config: CodecConfig, distances=None, orig_names=None
):
    """Dispatch a batch of SAME-geometry images as one device program;
    returns finalize() -> list of container bytes, each byte-identical to
    the per-image `encode_image` output. The striped (JXTS) encoder uses
    this so a large image's stripes share one dispatch and one transfer
    each way."""
    batch = np.stack([np.asarray(r) for r in rgbs])
    b, h, w = batch.shape[0], int(batch.shape[1]), int(batch.shape[2])
    if distances is None:
        distances = [config.distance] * b
    if any(float(d) <= 0.0 for d in distances):
        raise ValueError(
            "encode_images_batched_async is the LOSSY batch path; route "
            "d=0 images through encode_image/encode_images (modular mode)"
        )
    dists = [max(float(d), 0.05) for d in distances]
    if orig_names is None:
        orig_names = [""] * b
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], config.lanes)
    lay = padded_layout(h, w, lanes)
    cap = byte_capacity(lay["n_padded"])
    batch_j = jnp.asarray(batch)
    d_arr = jnp.asarray(dists, jnp.float32)

    pref, bu = _encode_imgs(
        batch_j,
        d_arr,
        first=_first_get_u32(lanes, h * w),
        height=h,
        width=w,
        effort=int(config.effort),
        hook_a=config.strategy.hook_a,
        hook_b=config.strategy.hook_b,
        lanes=lanes,
        cap_bytes=cap,
    )
    want = _window_from_history(lanes, h, w, dists)
    if want is not None and want < pref.shape[1]:
        pref = _pref_rows(bu, want)
    pref.copy_to_host_async()

    def finalize() -> list:
        got_all = np.asarray(pref)
        out = []
        for i in range(b):
            cfg_d = replace(config, distance=dists[i])
            k = (h, w, lanes, _dist_key(dists[i]), "var")
            _NEED_HISTORY[k] = max(
                _NEED_HISTORY.get(k, 0), _need_u32(got_all[i], lanes)
            )
            pieces = _parse_packed(got_all[i], bu[i], lanes)
            out.append(
                _assemble_container(
                    h, w, cfg_d, orig_names[i], lanes, lay, *pieces
                )
            )
        return out

    return finalize


def _first_get_u32(lanes: int, n_px: int, lossless: bool = False) -> int:
    """Size (u32 slots) of the speculative first device_get: header + a
    payload window covering ~4 bpp lossy / ~14 bpp lossless. Bigger streams
    trigger one extra tail fetch."""
    bpp_u32 = n_px // 2 if lossless else n_px // 8
    from jxl_jax.codec.layout import LL_Q

    n_ctx = 3 + 3 * LL_Q if lossless else N_CTX
    # + 2*BLK_U32: worst-case block rounding of the words + mantissa sections
    return _packed_header_u32(lanes, n_ctx) + bpp_u32 + 4096 + 2 * BLK_U32


# Largest packed-prefix size (u32) actually observed per (height, width,
# lanes, distance bucket): later grid rows fetch a window sized ~1.5x the
# biggest stream seen instead of the worst-case ~4 bpp default, which
# cuts the device->host bytes; an underestimate is only a per-row tail
# fetch (_parse_packed handles it).
_NEED_HISTORY: dict = {}


def _dist_key(d: float) -> int:
    import math

    return int(round(2.0 * math.log2(max(float(d), 0.05))))


@partial(jax.jit, static_argnames=("want",))
def _pref_1d(buf, want: int):
    """1-D twin of _pref_rows for the single-image encode path."""
    return jax.lax.slice(buf, (0,), (want,))


@partial(jax.jit, static_argnames=("want",))
def _pref_rows(bufs, want: int):
    """Host-chosen fetch window over already-computed grid buffers — a
    separate tiny program, so resizing the window never recompiles the
    encoder itself (its static `first` stays at the conservative
    default)."""
    return jax.lax.slice(bufs, (0, 0), (bufs.shape[0], want))


def _window_from_history(lanes: int, h: int, w: int, dists, mode: str = "var"):
    """Fetch-window size (u32, bucketed in fixed 8192-u32 / 32 KB steps
    to bound compile count) from history, or None until every distance
    bucket has been observed. `mode` separates the VarDCT and modular
    paths' histories (same geometry, ~30x different stream sizes)."""
    needs = [_NEED_HISTORY.get((h, w, lanes, _dist_key(d), mode)) for d in dists]
    if any(n is None for n in needs):
        return None
    want = int(max(needs) * 1.3) + 2 * BLK_U32
    step = 8192  # 32 KB steps: <= ~7 distinct windows per shape
    return -(-want // step) * step


def _need_u32(got: np.ndarray, lanes: int, n_ctx: int = N_CTX) -> int:
    """Exact used prefix length (u32) of a fetched packed buffer."""
    n_words = int(got[0])
    total_bytes = int(got[1])
    ws_used = ((n_words + WBLK - 1) // WBLK) * BLK_U32
    ms_used = ((total_bytes + MBLK - 1) // MBLK) * BLK_U32
    return _packed_header_u32(lanes, n_ctx) + ws_used + ms_used


def _parse_packed(got: np.ndarray, buf, lanes: int, n_ctx: int = N_CTX):
    """Split a fetched packed-prefix into container pieces, fetching the
    tail of `buf` if the speculative window was too small. The tables
    arrive CLUSTERED (cmap + <= K_CLUSTERS rows); the expanded [n_ctx, A]
    matrix the container writer wants is a host-side gather."""
    hdr = _packed_header_u32(lanes, n_ctx)
    n_words = int(got[0])
    total_bytes = int(got[1])
    G = lanes // GROUP
    wcounts = got[2 : 2 + G].astype(np.uint32)
    mcounts = got[10 : 10 + G].astype(np.uint32)
    ws_used = ((n_words + WBLK - 1) // WBLK) * BLK_U32
    ms_used = ((total_bytes + MBLK - 1) // MBLK) * BLK_U32
    need = hdr + ws_used + ms_used
    if need > got.shape[0]:
        tail = jax.device_get(jax.lax.slice(buf, (got.shape[0],), (need,)))
        got = np.concatenate([got, tail])
    params = int(got[18])
    o = 20
    cm = got[o : o + _cmap_u32(n_ctx)]
    cmap = np.stack(
        [(cm >> (8 * j)) & 0xFF for j in range(4)], axis=1
    ).reshape(-1)[:n_ctx]
    o += _cmap_u32(n_ctx)
    k_cl = min(K_CLUSTERS, n_ctx)
    tb = got[o : o + _tables_u32(n_ctx)].reshape(k_cl, -1)
    tables = np.stack([tb & 0xFFFF, tb >> 16], axis=2).reshape(k_cl, -1)[
        :, :ALPHABET
    ]
    o += _tables_u32(n_ctx)
    freq = tables[cmap].astype(np.uint32)
    states = got[o:hdr]
    words_b = _unpack_u16_blocks_np(got[hdr : hdr + ws_used], n_words)
    mant_b = _unpack_u8_blocks_np(got[hdr + ws_used : need], total_bytes)
    return freq, states, words_b, mant_b, wcounts, mcounts, params


def pick_lanes(n_tokens: int, max_lanes: int) -> int:
    """Adapt rANS lane count to the stream size: each lane costs 4 header
    bytes (final state), so small images use fewer, longer streams. Floor
    is one 128-lane group (the grouped coder's unit).

    AUTO-GROW: when the caller left the default 256-lane ratio-first
    setting, multi-megapixel streams upgrade to 512/1024 lanes — the
    decoder's serial step count drops 2-4x, and the +1-3 KB of per-lane
    header states is <= ~0.5% of such containers. The thresholds are in
    TOKENS (~3.02 per pixel): >= 6M (~2 MP) -> 512, >= 12M (~4 MP) ->
    1024. An explicit non-default `--lanes` pins the count (the sweep's
    0.4 MP corpus stays at 256 — ratio regression exactly 0)."""
    if max_lanes == 256:
        if n_tokens >= 12_000_000:
            max_lanes = 1024
        elif n_tokens >= 6_000_000:
            max_lanes = 512
    lanes = max(max_lanes, GROUP)
    while lanes > GROUP and n_tokens // lanes < 512:
        lanes //= 2
    return lanes


def encode_image(rgb: np.ndarray, config: CodecConfig, orig_name: str = "") -> bytes:
    """Encode an RGB u8 [H, W, 3] image to JXT bytes.

    distance == 0 selects the TRUE LOSSLESS modular mode (exact integer
    round trip, codec/lossless.py) — matching cjxl semantics for the legacy
    grid's d=0.0 point (`old_test_jxl.py:16-27`). Lossy distances are
    floored at 0.05 to keep quantized values within token range.

    Images above the single-section cap (container.MAX_PIXELS, 64 MP)
    must ride the striped JXTS format (codec.tiled.encode_image_striped;
    encode_file routes there automatically) — the hardened decoder
    rejects larger monolithic sections.
    """
    from jxl_jax.codec.container import MAX_PIXELS

    if int(rgb.shape[0]) * int(rgb.shape[1]) > MAX_PIXELS:
        raise ValueError(
            f"{rgb.shape[0]}x{rgb.shape[1]} exceeds the {MAX_PIXELS}-pixel "
            "single-section cap: use codec.tiled.encode_image_striped "
            "(the JXTS gigapixel format)"
        )
    return encode_image_async(rgb, config, orig_name)()


def _assemble_container(
    h, w, config, orig_name, lanes, lay, freq_np, states_np, words_b, mant_b,
    wcounts, mcounts, params=2, modular=None, acs_extra=b"",
) -> bytes:
    if modular is None:
        modular = config.distance <= 0.0
    header = JxtHeader(
        height=h,
        width=w,
        distance=float(config.distance),
        effort=int(config.effort),
        strategy=int(config.strategy.value),
        orig_name=orig_name,
        lanes=lanes,
        n_tokens=lay["n_tokens"],
        n_ctx=lay["n_ctx"],
        alphabet=ALPHABET,
        # EPF: on only when BOTH the config allows it and the encoder's
        # measured decision (params bit 5, tokens_from_rgb) says it helps
        # this image at this distance; modular mode (flag bit 1: lossless
        # d=0 or modular-lossy d>0) never filters.
        flags=(
            1
            if (
                config.epf
                and not modular
                and config.distance > 0.0
                and ((int(params) >> 5) & 1)
            )
            else 0
        )
        | (2 if modular else 0)
        # v8 coding-mode field in bits 2-7: for lossy streams bits 0-1 =
        # dc predictor / bit 2 = acs-map pred / bit 3 = qf-map pred /
        # bit 4 = nnz-map pred / bit 5 = epf-decision (tokens_from_rgb);
        # for lossless, 3 x 2-bit per-channel predictor modes
        # (lossless.lossless_tokens)
        | ((int(params) & 0x3F) << 2),
    )
    stream = JxtStream(
        header=header,
        freq=freq_np.astype(np.uint32),
        states=states_np.astype(np.uint32),
        stream_words=words_b,
        mant_bytes=mant_b,
        wcounts=np.asarray(wcounts, dtype=np.uint32),
        mcounts=np.asarray(mcounts, dtype=np.uint32),
        acs_extra=acs_extra,
    )
    return write_container(stream)


def encode_image_grid_async(
    rgb: np.ndarray, config: CodecConfig, distances, orig_name: str = ""
):
    """Dispatch a whole grid-row encode now; returns finalize() -> list of
    container byte strings (one per distance, same order).

    All distances share a single compiled program (distance is traced), so
    a 10-point sweep row costs one kernel launch + one batched transfer
    instead of 10 of each. The async split lets callers overlap row k's
    fetch + container assembly with row k+1's device compute (the sweep
    driver and bench pipeline rows at depth 2).
    """
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], config.lanes)
    lay = padded_layout(h, w, lanes)
    cap = byte_capacity(lay["n_padded"])
    d_arr = jnp.asarray([max(float(d), 0.05) for d in distances], jnp.float32)
    mod_fin = (
        _modular_grid_async(rgb, config, distances, orig_name)
        if (config.modular and _modular_candidate(rgb))
        else None
    )

    pref, b = _encode_grid(
        jnp.asarray(rgb),
        d_arr,
        first=_first_get_u32(lanes, h * w),
        height=h,
        width=w,
        effort=int(config.effort),
        hook_a=config.strategy.hook_a,
        hook_b=config.strategy.hook_b,
        lanes=lanes,
        cap_bytes=cap,
    )
    # One batched speculative get over the whole grid row, enqueued at
    # dispatch time (copy_to_host_async before the compute is done) so
    # np.asarray in finalize blocks directly on the copy. Once history
    # covers this (size, distance) bucket, fetch only a ~1.5x-observed-need
    # window of the buffers instead of the ~4 bpp static prefix — at d=1
    # that roughly halves the device->host bytes.
    want = _window_from_history(
        lanes, h, w, [max(float(d), 0.05) for d in distances]
    )
    if want is not None and want < pref.shape[1]:
        pref = _pref_rows(b, want)
    pref.copy_to_host_async()

    def finalize() -> list:
        got_all = np.asarray(pref)
        mod_list = mod_fin() if mod_fin is not None else None
        out = []
        for i, d in enumerate(distances):
            cfg_d = replace(config, distance=max(float(d), 0.05))
            k = (h, w, lanes, _dist_key(cfg_d.distance), "var")
            _NEED_HISTORY[k] = max(
                _NEED_HISTORY.get(k, 0), _need_u32(got_all[i], lanes)
            )
            pieces = _parse_packed(got_all[i], b[i], lanes)
            var_bytes = _assemble_container(
                h, w, cfg_d, orig_name, lanes, lay, *pieces, modular=False
            )
            if mod_list is not None:
                var_bytes = _pick_mode(
                    rgb, var_bytes, mod_list[i], cfg_d.distance
                )
            out.append(var_bytes)
        return out

    return finalize


def encode_image_grid(
    rgb: np.ndarray, config: CodecConfig, distances, orig_name: str = ""
) -> list:
    """Synchronous form of encode_image_grid_async."""
    return encode_image_grid_async(rgb, config, distances, orig_name)()


def _modular_mode() -> int:
    """Modular-lossy decision mode: 0 = off, 1 = auto (content pre-screen
    + measured-bytes pick, the default), 2 = force (always code modular —
    calibration / A/B tooling). JXL_JAX_MODULAR overrides."""
    import os

    v = os.environ.get("JXL_JAX_MODULAR")
    return 1 if v is None or v == "" else int(v)


def _mode_rule() -> tuple:
    """Constants of the mode-decision dominance rule (see _pick_mode):
    (byte_win, sse_tol, sse_win, byte_tol). JXL_JAX_MOD_RULE='a,b,c,d'
    overrides for A/B runs."""
    import os

    v = os.environ.get("JXL_JAX_MOD_RULE")
    if v:
        a, b, c, d = (float(x) for x in v.split(","))
        return a, b, c, d
    return 0.5, 3.2, 0.5, 1.2


@jax.jit
def _sse_u8(a, b):
    da = a.astype(jnp.float32) - b.astype(jnp.float32)
    return jnp.sum(da * da)


def _pick_mode(rgb, var_bytes: bytes, mod_bytes: bytes, distance: float) -> bytes:
    """Per-image coding-mode decision by MEASURED rate and distortion:
    decode both candidate containers (device-resident, only two scalars
    come back to the host) and keep the modular container iff one of

      1. it dominates outright  (bytes <= VarDCT's  and  SSE <= VarDCT's)
      2. big byte win           (bytes <= 0.5x  and  SSE <= 3.2x, ~5 dB)
      3. big quality win        (SSE <= 0.5x  and  bytes <= 1.2x)

    holds. A single-lambda J = R + D/lambda score was measured WORSE on
    the corpus (tools/modular_calib.py): on graphics the
    two paths' curves are so far apart that any lambda misranks some
    distances; the dominance rule agrees with the interpolated-RD-curve
    oracle on 47/47 grid points. Runs only on _modular_candidate images,
    so photographic sweeps never pay the extra decodes."""
    from jxl_jax.codec.decode import decode_bytes_device

    ref = jnp.asarray(rgb)
    sv = float(_sse_u8(decode_bytes_device(var_bytes), ref))
    sm = float(_sse_u8(decode_bytes_device(mod_bytes), ref))
    rv, rm = len(var_bytes), len(mod_bytes)
    byte_win, sse_tol, sse_win, byte_tol = _mode_rule()
    pick_mod = (
        (rm <= rv and sm <= sv)
        or (rm <= byte_win * rv and sm <= sse_tol * sv)
        or (sm <= sse_win * sv and rm <= byte_tol * rv)
    )
    return mod_bytes if pick_mod else var_bytes


def _modular_candidate(rgb: np.ndarray) -> bool:
    """Host pre-screen: is this image plausibly synthetic/sharp content
    where the modular path could beat VarDCT? Measures the fraction of
    pixels exactly equal to BOTH their west and north neighbors — ~0 on
    photographic/noisy content (so photo sweeps never pay the second
    encode), large on text/graphics/screenshots. The actual mode decision
    is by measured container bytes; this only gates whether the modular
    encode is dispatched at all."""
    mode = _modular_mode()
    if mode == 0:
        return False
    if mode >= 2:
        return True
    a = np.asarray(rgb)
    if a.ndim != 3 or a.shape[0] < 2 or a.shape[1] < 2:
        return False
    if a.shape[0] * a.shape[1] > (1 << 24):
        # >16.7 MP: bound the screen's ~2 B/pixel of host temporaries by
        # subsampling — exact equality at stride 4 still separates flat
        # UI/glyph runs (typically >= 8 px) from photographic content
        a = a[::4, ::4]
    eqw = (a[:, 1:] == a[:, :-1]).all(axis=2)
    eqn = (a[1:, :] == a[:-1, :]).all(axis=2)
    flat = float(np.mean(eqw[1:, :] & eqn[:, 1:]))
    return flat >= 0.12


def _palette_async(idx, pal, config: CodecConfig, orig_name: str = ""):
    """Dispatch a palette-mode lossless encode (see _encode_palette_core);
    returns finalize() -> container bytes. Palette mode is signaled by the
    container's extra section being a non-empty N*3-byte palette on a
    lossless (flag bit 1, d=0) stream — self-describing, no format
    change."""
    h, w = int(idx.shape[0]), int(idx.shape[1])
    from jxl_jax.codec.layout import lossless_layout

    lanes = pick_lanes(3 * h * w, config.lanes)
    lay = lossless_layout(h, w, lanes)
    cap = byte_capacity(lay["n_padded"])
    pref, buf = _encode_palette_pref(
        jnp.asarray(idx),
        first=_first_get_u32(lanes, h * w, lossless=True),
        height=h,
        width=w,
        lanes=lanes,
        cap_bytes=cap,
    )
    pref.copy_to_host_async()

    def finalize() -> bytes:
        got = np.asarray(pref)
        pieces = _parse_packed(got, buf, lanes, n_ctx=lay["n_ctx"])
        return _assemble_container(
            h, w, config, orig_name, lanes, lay, *pieces,
            modular=True, acs_extra=pal.tobytes(),
        )

    return finalize


def _modular_async(rgb, config: CodecConfig, orig_name: str = ""):
    """Dispatch a modular-mode encode (d=0 lossless or d>0 modular-lossy,
    codec/lossless.py); returns finalize() -> container bytes."""
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    from jxl_jax.codec.layout import lossless_layout

    lanes = pick_lanes(3 * h * w, config.lanes)
    lay = lossless_layout(h, w, lanes)
    cap = byte_capacity(lay["n_padded"])

    pref, b = _encode_modular_pref(
        jnp.asarray(rgb),
        jnp.float32(config.distance),
        first=_first_get_u32(lanes, h * w, lossless=True),
        height=h,
        width=w,
        lanes=lanes,
        cap_bytes=cap,
    )
    # fetch-window history ("mod" namespace): the static lossless-sized
    # speculative prefix covers ~14 bpp, but modular-LOSSY streams run
    # ~0.5 bpp, so the over-fetch would dominate the transfer
    want = _window_from_history(lanes, h, w, [config.distance], mode="mod")
    if want is not None and want < pref.shape[0]:
        pref = _pref_1d(b, want)
    pref.copy_to_host_async()

    def finalize() -> bytes:
        got = np.asarray(pref)
        k = (h, w, lanes, _dist_key(config.distance), "mod")
        _NEED_HISTORY[k] = max(
            _NEED_HISTORY.get(k, 0), _need_u32(got, lanes, n_ctx=lay["n_ctx"])
        )
        pieces = _parse_packed(got, b, lanes, n_ctx=lay["n_ctx"])
        return _assemble_container(
            h, w, config, orig_name, lanes, lay, *pieces, modular=True
        )

    return finalize


def _modular_grid_async(rgb, config: CodecConfig, distances, orig_name: str = ""):
    """Grid twin of _modular_async: ONE dispatch encodes the modular path
    at every distance of a sweep row; finalize() -> list of container
    bytes (same order)."""
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    from jxl_jax.codec.layout import lossless_layout

    lanes = pick_lanes(3 * h * w, config.lanes)
    lay = lossless_layout(h, w, lanes)
    cap = byte_capacity(lay["n_padded"])
    d_arr = jnp.asarray([max(float(d), 0.05) for d in distances], jnp.float32)

    pref, b = _encode_modular_grid(
        jnp.asarray(rgb),
        d_arr,
        first=_first_get_u32(lanes, h * w, lossless=True),
        height=h,
        width=w,
        lanes=lanes,
        cap_bytes=cap,
    )
    want = _window_from_history(
        lanes, h, w, [max(float(d), 0.05) for d in distances], mode="mod"
    )
    if want is not None and want < pref.shape[1]:
        pref = _pref_rows(b, want)
    pref.copy_to_host_async()

    def finalize() -> list:
        got_all = np.asarray(pref)
        out = []
        for i, d in enumerate(distances):
            cfg_d = replace(config, distance=max(float(d), 0.05))
            k = (h, w, lanes, _dist_key(cfg_d.distance), "mod")
            _NEED_HISTORY[k] = max(
                _NEED_HISTORY.get(k, 0),
                _need_u32(got_all[i], lanes, n_ctx=lay["n_ctx"]),
            )
            pieces = _parse_packed(got_all[i], b[i], lanes, n_ctx=lay["n_ctx"])
            out.append(
                _assemble_container(
                    h, w, cfg_d, orig_name, lanes, lay, *pieces, modular=True
                )
            )
        return out

    return finalize


def encode_image_async(rgb: np.ndarray, config: CodecConfig, orig_name: str = ""):
    """Dispatch an encode now; returns finalize() -> container bytes.

    Lets callers pipeline many encodes: dispatch all, then finalize in
    order — device compute for image i+1 overlaps the host-side fetch and
    container assembly of image i (the sweep driver and bench use this).

    Lossy encodes of synthetic-looking content (_modular_candidate) also
    dispatch the modular-lossy path and keep whichever container measures
    smaller (the analog of libjxl's VarDCT-vs-modular mode decision on
    graphics/text).
    """
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    lossless = config.distance <= 0.0
    if not lossless and config.distance < 0.05:
        config = replace(config, distance=0.05)
    if lossless:
        config = replace(config, distance=0.0, epf=False)
        plain_fin = _modular_async(rgb, config, orig_name)
        pal_res = _palette_of(rgb) if config.modular else None
        if pal_res is None:
            return plain_fin
        # <= 256 distinct colors: also code the luma-sorted index plane
        # through the palette path and keep the smaller container (both
        # are exact, so the decision is pure measured bytes)
        pal, idx = pal_res
        pal_fin = _palette_async(idx, pal, config, orig_name)

        def finalize_ll() -> bytes:
            plain_b, pal_b = plain_fin(), pal_fin()
            return pal_b if len(pal_b) < len(plain_b) else plain_b

        return finalize_ll
    else:
        lanes = pick_lanes(token_layout(h, w)["n_tokens"], config.lanes)
        lay = padded_layout(h, w, lanes)
        cap = byte_capacity(lay["n_padded"])
        mod_fin = (
            _modular_async(rgb, config, orig_name)
            if (config.modular and _modular_candidate(rgb))
            else None
        )

        pref, b = _encode_full_pref(
            jnp.asarray(rgb),
            jnp.float32(config.distance),
            first=_first_get_u32(lanes, h * w),
            height=h,
            width=w,
            effort=int(config.effort),
            hook_a=config.strategy.hook_a,
            hook_b=config.strategy.hook_b,
            lanes=lanes,
            cap_bytes=cap,
        )
        # Enqueue the device->host copy of the speculative prefix NOW,
        # behind the encode compute, so finalize's np.asarray blocks
        # directly on the copy.
        want = _window_from_history(lanes, h, w, [config.distance])
        if want is not None and want < pref.shape[0]:
            pref = _pref_1d(b, want)
        pref.copy_to_host_async()

        def finalize() -> bytes:
            got = np.asarray(pref)
            k = (h, w, lanes, _dist_key(config.distance), "var")
            _NEED_HISTORY[k] = max(
                _NEED_HISTORY.get(k, 0), _need_u32(got, lanes)
            )
            pieces = _parse_packed(got, b, lanes)
            var_bytes = _assemble_container(
                h, w, config, orig_name, lanes, lay, *pieces, modular=False
            )
            if mod_fin is not None:
                return _pick_mode(rgb, var_bytes, mod_fin(), config.distance)
            return var_bytes

        return finalize


def encode_images(jobs, pipeline_depth: int = 4) -> list:
    """Encode [(rgb, config, orig_name), ...] with a bounded dispatch
    pipeline; returns container bytes in order.

    Finalize (device_get + container assembly) runs on ONE dedicated IO
    thread so it overlaps the main thread's uploads and dispatches —
    without it the host alternates dispatch/fetch serially. Set
    JXL_JAX_NO_THREAD_IO=1 to force the serial path."""
    import os

    if os.environ.get("JXL_JAX_NO_THREAD_IO"):
        out = []
        pending = []
        for job in jobs:
            pending.append(encode_image_async(*job))
            if len(pending) >= pipeline_depth:
                out.append(pending.pop(0)())
        out.extend(fin() for fin in pending)
        return out

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = []
        for job in jobs:
            fin = encode_image_async(*job)
            futs.append(ex.submit(fin))
            if len(futs) >= pipeline_depth:
                # bound in-flight work: oldest must finish before the next
                # dispatch goes out
                futs[len(futs) - pipeline_depth].result()
        return [f.result() for f in futs]


def encode_file(in_path: str, out_path: str, config: CodecConfig) -> int:
    """Encode an image file; returns compressed size in bytes."""
    import os

    from jxl_jax.core.io import read_image

    rgb = read_image(in_path)
    from jxl_jax.codec.container import MAX_PIXELS

    if int(rgb.shape[0]) * int(rgb.shape[1]) > MAX_PIXELS:
        # above the single-section cap: route to the striped format
        from jxl_jax.codec.tiled import encode_image_striped

        data = encode_image_striped(
            rgb, config, orig_name=os.path.basename(in_path)
        )
    else:
        data = encode_image(rgb, config, orig_name=os.path.basename(in_path))
    with open(out_path, "wb") as f:
        f.write(data)
    return len(data)
