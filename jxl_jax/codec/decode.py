"""On-device JXT decoder — exact mirror of codec.encode.

Replaces the reference's host-side decode path (jpegxl-rs -> libjxl C++,
`image_reader.rs:370-439`). One packed upload, one fused program: the
grouped rANS decoder (the Triton kernel in entropy/triton_rans.py on the
GPU, its XLA scan twin on the CPU) decodes the whole token stream
INCLUDING mantissa consumption — it emits final values — then DC is
reconstructed with a separable 2D prefix sum (inverse of the unclamped
gradient predictor) and IDCT + CfL + EPF + inverse XYB are batched
matmuls/elementwise ops. Pixels are returned device-resident
(decode_stream_device), so only consumers that need host pixels pay for
the download.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jxl_jax.codec.container import JxtStream, read_container
from jxl_jax.codec.layout import token_layout
from jxl_jax.core.xyb import xyb_to_srgb
from jxl_jax.entropy.tokens import zigzag_unmap
from jxl_jax.strategy.acs import (
    ACS_DCT4X4,
    ACS_DCT4X8,
    ACS_DCT8X4,
    MERGE_LADDER,
    N_STRATEGIES,
    effective_multiplier,
    reassemble_merged,
    steps_field,
)
from jxl_jax.transforms.adaptive import QF_LEVELS, qf_multiplier
from jxl_jax.transforms.epf import epf_apply
from jxl_jax.transforms.dct import idct2d, inverse_zigzag_order, permute_last
from jxl_jax.transforms.quant import ac_recon_bias, dc_steps_t

_SQRT2 = float(np.sqrt(2.0))


def blocks_to_image(blocks: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """[3, nby, nbx, 8, 8] -> [3, height, width] (crop padding)."""
    nby, nbx = blocks.shape[1], blocks.shape[2]
    planes = blocks.transpose(0, 1, 3, 2, 4).reshape(3, nby * 8, nbx * 8)
    return planes[:, :height, :width]


def _reconstruct_sub8(storage: jnp.ndarray, dc: jnp.ndarray, acs: jnp.ndarray):
    """Pixel blocks for strategies 0..3, per-block selected by the acs map.

    storage: [3, nby, nbx, 8, 8] dequantized coefficient storage,
    dc: [3, nby, nbx] dequantized DC-plane values. Dense: every strategy's
    inverse transform is computed for every block (batched matmuls),
    then masked select — the jit-friendly dual of the encoder's search.
    """
    # DCT 8x8
    c8 = storage.at[..., 0, 0].set(dc)
    out8 = idct2d(c8)

    # DCT4X4: quadrants + Haar-mixed sub-DCs
    m = jnp.stack(
        [
            jnp.stack([dc, storage[..., 0, 4]], axis=-1),
            jnp.stack([storage[..., 4, 0], storage[..., 4, 4]], axis=-1),
        ],
        axis=-2,
    )  # [3, nby, nbx, 2, 2]
    subdc = idct2d(m)
    q44 = storage.reshape(*storage.shape[:-2], 2, 4, 2, 4).transpose(
        0, 1, 2, 3, 5, 4, 6
    )  # [3, nby, nbx, qy, qx, 4, 4]
    q44 = q44.at[..., 0, 0].set(subdc)
    p44 = idct2d(q44)  # [3, nby, nbx, 2, 2, 4, 4]
    out44 = p44.transpose(0, 1, 2, 3, 5, 4, 6).reshape(*storage.shape[:-2], 8, 8)

    # DCT8X4: left/right halves
    m1h = storage[..., 0, 4]
    s0 = (dc + m1h) / _SQRT2
    s1 = (dc - m1h) / _SQRT2
    h84 = storage.reshape(*storage.shape[:-2], 8, 2, 4).transpose(0, 1, 2, 4, 3, 5)
    h84 = h84.at[..., 0, 0, 0].set(s0).at[..., 1, 0, 0].set(s1)
    p84 = idct2d(h84)  # [3, nby, nbx, 2, 8, 4]
    out84 = p84.transpose(0, 1, 2, 4, 3, 5).reshape(*storage.shape[:-2], 8, 8)

    # DCT4X8: top/bottom halves
    m1v = storage[..., 4, 0]
    t0 = (dc + m1v) / _SQRT2
    t1 = (dc - m1v) / _SQRT2
    h48 = storage.reshape(*storage.shape[:-2], 2, 4, 8)
    h48 = h48.at[..., 0, 0, 0].set(t0).at[..., 1, 0, 0].set(t1)
    p48 = idct2d(h48)  # [3, nby, nbx, 2, 4, 8]
    out48 = p48.reshape(*storage.shape[:-2], 8, 8)

    sel = acs[None, :, :, None, None]
    out = jnp.where(sel == ACS_DCT4X4, out44, out8)
    out = jnp.where(sel == ACS_DCT8X4, out84, out)
    out = jnp.where(sel == ACS_DCT4X8, out48, out)
    return out


def _overlay_merged(pix: jnp.ndarray, storage, dc, acs, n: int, sid: int):
    """Overwrite pixels of n x n merged groups (dense compute + mask).

    The dense reassembly (full-image n x n IDCTs) is wrapped in a REAL
    lax.cond on "any group uses this size": photographic content rarely
    reaches 128/256, and decode is never vmapped (the RD-grid path is
    lax.map), so the cond actually skips the work at runtime — adding the
    full 16..256 ladder costs nothing when absent."""
    k = n // 8
    nby, nbx = acs.shape
    gby, gbx = nby // k, nbx // k
    if gby == 0 or gbx == 0:
        return pix
    mask = acs[: gby * k : k, : gbx * k : k] == sid  # group origin blocks

    def overlay(pix):
        slots = storage[:, : gby * k, : gbx * k].reshape(
            3, gby, k, gbx, k, 8, 8
        ).transpose(0, 1, 3, 2, 4, 5, 6)  # [3, gby, gbx, k, k, 8, 8]
        dcb = dc[:, : gby * k, : gbx * k].reshape(3, gby, k, gbx, k).transpose(
            0, 1, 3, 2, 4
        )
        tiles = reassemble_merged(slots, dcb)  # [3, gby, gbx, n, n]
        tile_img = tiles.transpose(0, 1, 3, 2, 4).reshape(3, gby * n, gbx * n)
        mask_img = jnp.repeat(jnp.repeat(mask, n, axis=0), n, axis=1)
        hp, wp = pix.shape[-2:]
        tile_full = jnp.pad(tile_img, ((0, 0), (0, hp - gby * n), (0, wp - gbx * n)))
        mask_full = jnp.pad(mask_img, ((0, hp - gby * n), (0, wp - gbx * n)))
        return jnp.where(mask_full[None], tile_full, pix)

    return jax.lax.cond(jnp.any(mask), overlay, lambda p: p, pix)


def _pow2_bucket(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _route() -> str:
    """The rANS decoder for this process's device (triton_rans.decode_route):
    the Triton kernel on the GPU, the bit-exact XLA twin on the CPU."""
    from jxl_jax.entropy.triton_rans import decode_route

    return decode_route()


def _nnz_map_from_padded(vals_a, params, lay):
    """Decoded phase-A PADDED values -> (q_final [3, nb], q_sorted [3, nb]).

    Reads the nnz-bucket section at its padded span offsets, undoes the
    (flag-selected) causal prediction, clips to the bucket range, and
    applies the shared stable bucket sort (encode.bucket_perm)."""
    from jxl_jax.codec.encode import bucket_perm
    from jxl_jax.codec.layout import NNZ_Q

    nb = lay["nb"]
    nby, nbx = lay["nby"], lay["nbx"]
    pred_on = ((jnp.asarray(params, jnp.uint32) >> 5) & 1).astype(jnp.bool_)
    chans = []
    for i in range(3):
        _c, dst, n_real, _p = lay["spans"][3 + i]  # nnz spans follow CfL
        raw = vals_a[dst : dst + n_real].astype(jnp.int32).reshape(nby, nbx)
        res = zigzag_unmap(vals_a[dst : dst + n_real]).reshape(nby, nbx)
        v = jnp.where(pred_on, unpredict_lcol(res), raw)
        chans.append(jnp.clip(v, 0, NNZ_Q - 1).reshape(-1))
    q_final = jnp.stack(chans)
    perm = bucket_perm(q_final, nb)
    q_sorted = jnp.take_along_axis(q_final, perm, axis=1)
    return q_final, q_sorted


def _layout(height: int, width: int, lanes: int, lossless: bool) -> dict:
    from jxl_jax.codec.layout import lossless_layout, padded_layout

    if lossless:
        return lossless_layout(height, width, lanes)
    return padded_layout(height, width, lanes)


def _rans_values(packed_b, *, height, width, lanes, capw, capm, route, lossless):
    """rANS-decode N same-geometry packed streams through both scan phases.

    Both modes decode in TWO phases: static-context sections first, then
    the conditioned phase whose per-step contexts derive from phase A
    (lossy: the nnz-bucket map -> AC contexts; lossless: the 8x8
    activity-flag map -> pixel contexts). The rANS carry (states + stream
    pointers) threads from one phase into the next.

    route: "triton" | "interpret" (the kernel, compiled for the GPU or
    under the Pallas interpreter: all N streams in one launch per phase)
    | "xla" (the scan twin, one stream at a time).

    Returns (values [N, T*lanes] u32 padded-stream values, params [N] u32,
    carry_a, carry_b), a carry being (states [N*G, 128] u32, pointers
    [2, N*G] i32 word / mantissa-byte) after that phase."""
    from jxl_jax.codec.encode import ac_step_ctx
    from jxl_jax.entropy.grouped import GROUP, decode_grouped, kernel_rows
    from jxl_jax.entropy.triton_rans import ROUTES, decode_grouped_triton

    assert route in ROUTES, route
    lay = _layout(height, width, lanes, lossless)
    n = packed_b.shape[0]
    G = lanes // GROUP
    n_ctx = lay["n_ctx"]
    t_a = lay["t_a"]
    t_b = lay["T"] - t_a
    step_ctx_a = jnp.asarray(lay["step_ctx"][:t_a])

    def unpack(p):
        freq = _expand_freq(p, n_ctx)
        states, wg, mg = _unpack_sections(p, n_ctx, lanes, capw, capm)
        cum = jnp.concatenate(
            [jnp.zeros((n_ctx, 1), jnp.uint32), jnp.cumsum(freq, axis=1)[:, :-1]],
            axis=1,
        )
        return p[0], states, wg, mg, freq, cum, kernel_rows(step_ctx_a, freq, cum)

    # per-image work is vmapped, not unrolled: one copy in the program
    # whatever the row length
    params, states, words, mant, freq, cum, rows_a = jax.vmap(unpack)(packed_b)
    states = states.reshape(n * G, GROUP)
    words = words.reshape(n * G, capw)
    mant = mant.reshape(n * G, capm)
    rows_a = rows_a.transpose(1, 0, 2)  # [t_a, N, 128]

    def phase_b_rows(v, p, f, c):
        # phase-B rows from a stream's decoded conditioning section
        # (lossy: the nnz map; modular: the activity flag maps)
        if lossless:
            ctx_b = _ll_phase_b_ctx(v, lay)
        else:
            ctx_b = ac_step_ctx(lay, _nnz_map_from_padded(v, p, lay)[1])
        return kernel_rows(ctx_b, f, c)

    def rows_b_of(vals_a):
        return jax.vmap(phase_b_rows)(vals_a, params, freq, cum).transpose(1, 0, 2)

    if route != "xla":
        kw = dict(lanes=lanes, interpret=route == "interpret")
        vals_a, st_a, ptr_a = decode_grouped_triton(
            words, mant, states, rows_a, T=t_a, **kw
        )
        vals_b, st_b, ptr_b = decode_grouped_triton(
            words, mant, st_a, rows_b_of(vals_a), T=t_b, ptr_init=ptr_a, **kw
        )
        return (
            jnp.concatenate([vals_a, vals_b], axis=1), params,
            (st_a, ptr_a), (st_b, ptr_b),
        )

    def twin(T, rows, carry):
        """Scan twin over each stream (lax.map when N > 1); carry in/out in
        the kernel's (states, pointers) form."""
        st, ptr = carry

        def one(args):
            w, m, x, r, gp, bp = args
            v, xf, gf, bf = decode_grouped(
                w, m, x.reshape(-1), r, T=T, lanes=lanes, gptr0=gp, bptr0=bp,
                return_carry=True,
            )
            return v, xf.reshape(G, GROUP), gf, bf

        xs = (
            words.reshape(n, G, -1), mant.reshape(n, G, -1),
            st.reshape(n, G, GROUP), rows.transpose(1, 0, 2),
            ptr[0].reshape(n, G), ptr[1].reshape(n, G),
        )
        if n == 1:
            v, xf, gf, bf = (o[None] for o in one(tuple(a[0] for a in xs)))
        else:
            v, xf, gf, bf = jax.lax.map(one, xs)
        return v, (xf.reshape(n * G, GROUP), jnp.stack([gf.reshape(-1), bf.reshape(-1)]))

    vals_a, carry_a = twin(t_a, rows_a, (states, jnp.zeros((2, n * G), jnp.int32)))
    vals_b, carry_b = twin(t_b, rows_b_of(vals_a), carry_a)
    return jnp.concatenate([vals_a, vals_b], axis=1), params, carry_a, carry_b


def _decode_packed_core(packed, distance, *, height, width, lanes, epf, capw, capm, route, lossless=False, palette=False, return_planes=False):
    """Unpack the single uploaded u32 buffer and decode.

    Host->device layout (static offsets; capw/capm are power-of-two bucket
    sizes so jit specializations stay bounded):
      [0]            coding-params word (JxtHeader.decode_params) — TRACED,
                     so one compiled decoder serves streams with different
                     DC predictor modes (grid rows never split compilation)
      [1:1+NF]       freq tables (n_ctx*A u32, cluster-expanded)
      [..:..+lanes]  final rANS states
      [.. : ..+G*capw/2] per-group rANS words, two u16 words per u32
      [.. : ..+G*capm/4] per-group mantissa bytes, four per u32
    The word/mantissa sections ride DENSE (the kernel-facing one-element-
    per-u32 layout would quadruple the mantissa upload); the device
    re-expands with a bitcast + widen (_unpack_sections), which XLA lowers
    without the minor-dim relayout a strided interleave would cost.

    The rANS stage (both scan phases, _rans_values) runs on `route`:
    "triton" / "interpret" (the kernel of entropy/triton_rans.py) or
    "xla" (its scan twin).
    """
    lay = _layout(height, width, lanes, lossless)
    params = packed[0]
    values_p = _rans_values(
        packed[None], height=height, width=width, lanes=lanes, capw=capw,
        capm=capm, route=route, lossless=lossless,
    )[0][0]

    # strip the per-run K-padding back out (static slices)
    parts = [
        jax.lax.slice(values_p, (dst,), (dst + n_real,))
        for _c, dst, n_real, _n_pad in lay["spans"]
    ]
    values = jnp.concatenate(parts)
    if lossless:
        from jxl_jax.codec.lossless import reconstruct_lossless

        pal = None
        if palette:
            # _pack_stream_np appends the palette as the last 256 u32
            # (one 0x00RRGGBB word per entry) of the upload buffer
            pw = packed[-256:]
            pal = jnp.stack(
                [(pw >> 16) & 255, (pw >> 8) & 255, pw & 255], axis=-1
            ).astype(jnp.uint8)
        # distance is traced: d=0 lossless and d>0 modular-lossy streams
        # share this program (modular_steps(0) == 1 -> exact round trip)
        return reconstruct_lossless(
            values, params, height=height, width=width, distance=distance,
            pal=pal,
        )
    return _reconstruct(
        values, distance, params,
        height=height, width=width, epf=epf, return_planes=return_planes,
    )


_decode_packed = partial(
    jax.jit,
    static_argnames=(
        "height", "width", "lanes", "epf", "capw", "capm", "route", "lossless", "palette", "return_planes",
    ),
)(_decode_packed_core)


def _ll_phase_b_ctx(vals_a, lay):
    """Lossless/modular phase-B step contexts from the decoded activity
    flag maps (shared with _decode_packed_core's per-image path)."""
    from jxl_jax.codec.encode import bucket_perm
    from jxl_jax.codec.layout import LL_Q
    from jxl_jax.codec.lossless import ll_step_ctx

    nbl = lay["nbl"]
    chans = []
    for i in range(3):
        _c, dst, n_real, _p = lay["spans"][i]
        chans.append(
            jnp.clip(vals_a[dst : dst + n_real].astype(jnp.int32), 0, LL_Q - 1)
        )
    q = jnp.stack(chans)
    q_sorted = jnp.take_along_axis(q, bucket_perm(q, nbl), axis=1)
    return ll_step_ctx(lay, q_sorted)[lay["t_a"] :]


@partial(
    jax.jit,
    static_argnames=(
        "height", "width", "lanes", "epf", "capw", "capm", "route", "lossless",
    ),
)
def _decode_packed_grid(packed_b, distances, *, height, width, lanes, epf, capw, capm, route, lossless=False):
    """Decode a whole RD-sweep row in ONE dispatch (ROADMAP #3).

    packed_b: [N, L] u32 (per-point packed buffers, shared capw/capm
    buckets); distances: [N] f32. With the kernel the rANS scans of ALL
    N images run in one launch per phase (one program per 128-lane group
    of every image), so a row costs about one image's serial steps; the
    XLA twin scans one image after another (_rans_values). Reconstruction
    (dequant/IDCT/CfL/EPF) then lax.maps per image. `lossless` (static)
    selects the modular-family layout and
    reconstruction: a UNIFORM row of modular(-lossy) points batches the
    same way (round 5) — phase B conditions on the decoded activity
    maps instead of the nnz map. Mixed rows and palette streams stay on
    the per-stream path (decode_bytes_grid_stacked returns None)."""
    lay = _layout(height, width, lanes, lossless)
    values_p, params_v, _carry_a, _carry_b = _rans_values(
        packed_b, height=height, width=width, lanes=lanes, capw=capw,
        capm=capm, route=route, lossless=lossless,
    )  # [N, n_padded]

    def finish(args):
        vp, d, params = args
        values = jnp.concatenate(
            [
                jax.lax.slice(vp, (dst,), (dst + n_real,))
                for _c, dst, n_real, _n_pad in lay["spans"]
            ]
        )
        if lossless:
            from jxl_jax.codec.lossless import reconstruct_lossless

            return reconstruct_lossless(
                values, params, height=height, width=width, distance=d
            )
        return _reconstruct(
            values, d, params, height=height, width=width, epf=epf
        )

    return jax.lax.map(finish, (values_p, distances, params_v))


def unpredict_lcol(res: jnp.ndarray) -> jnp.ndarray:
    """Inverse of codec.encode.predict_lcol: first column is a downward
    cumsum, then every row is a rightward cumsum — two prefix sums, no
    sequential wavefront (the same trick the DC gradient inverse uses)."""
    col0 = jnp.cumsum(res[:, :1], axis=0)
    rest = jnp.concatenate([col0, res[:, 1:]], axis=1)
    return jnp.cumsum(rest, axis=1)


def _reconstruct(values, distance, params, *, height, width, epf=True, return_planes=False, skip_merged=False):
    """Decoded value stream -> pixels (dequant, IDCT, CfL, EPF, colorspace).

    params (traced u32, JxtHeader.decode_params): bits 0-1 DC predictor
    mode, bit 2 AC reconstruction bias, bit 3 causal ACS/QF prediction —
    all selected with masked wheres so one compiled decoder serves v5/v6
    and v7 streams alike (the alternate interpretations cost two tiny
    cumsums, nothing at image scale).

    return_planes=True stops BEFORE the EPF + colorspace tail and returns
    (padded pre-EPF XYB planes [3, hp, wp] with B as Y-residual, eff_mul
    [nby, nbx]) — the striped gigapixel decoder (codec.tiled) stitches
    stripes in plane space and runs ONE seam-exact EPF over the full image
    instead of per-stripe filters with replicated edges."""
    lay = token_layout(height, width)
    signed = zigzag_unmap(values)
    params = jnp.asarray(params, jnp.uint32)
    dc_mode = (params & 3).astype(jnp.int32)
    bias_on = ((params >> 2) & 1).astype(jnp.float32)

    n_acs, n_qf, n_cfl, n_dc = lay["n_acs"], lay["n_qf"], lay["n_cfl"], lay["n_dc"]
    nb, nby, nbx = lay["nb"], lay["nby"], lay["nbx"]
    ty, tx = lay["ty"], lay["tx"]

    def field(start, n, levels, pred_bit):
        """Per-block map section: causal residuals when the encoder's
        per-image choice (params bit) says so, raw ids otherwise."""
        pred_on = ((params >> pred_bit) & 1).astype(jnp.bool_)
        raw = values[start : start + n].astype(jnp.int32).reshape(nby, nbx)
        res = signed[start : start + n].reshape(nby, nbx)
        v = jnp.where(pred_on, unpredict_lcol(res), raw)
        return jnp.clip(v, 0, levels - 1)

    acs = field(0, n_acs, N_STRATEGIES, 3)
    qf_idx = field(n_acs, n_qf, QF_LEVELS, 4)
    qf_mul = qf_multiplier(qf_idx)

    cfl = signed[n_acs + n_qf : n_acs + n_qf + n_cfl].reshape(2, ty, tx)

    # nnz-bucket map (v8): conditions the AC contexts AND defines the AC
    # block-axis sort order that must be undone below
    from jxl_jax.codec.encode import bucket_perm
    from jxl_jax.codec.layout import NNZ_Q

    nnz_start = n_acs + n_qf + n_cfl
    n_nnz = lay["n_nnz"]
    q_final = jnp.stack(
        [
            field(nnz_start + c * nb, nb, NNZ_Q, 5).reshape(-1)
            for c in range(3)
        ]
    )
    perm = bucket_perm(q_final, nb)
    inv_perm = jnp.argsort(perm, axis=1)

    dc_start = nnz_start + n_nnz
    dc_res = signed[dc_start : dc_start + n_dc].reshape(3, nby, nbx)
    # inverse DC predictor: none / west (row cumsum) / gradient (2D cumsum)
    dc_w = jnp.cumsum(dc_res, axis=2)
    dcq = jnp.where(
        dc_mode == 0, dc_res, jnp.where(dc_mode == 1, dc_w, jnp.cumsum(dc_w, axis=1))
    )

    ac_sorted = signed[dc_start + n_dc :].reshape(3, 63, nb).transpose(0, 2, 1)
    ac = jnp.take_along_axis(ac_sorted, inv_perm[:, :, None], axis=1)  # [3, nb, 63]
    # Rebuild the 64-coefficient block: DC slot 0, then inverse zigzag
    # (as a permutation matmul — see transforms.dct.permute_last).
    acq_zz = jnp.concatenate([jnp.zeros((3, nb, 1), jnp.int32), ac], axis=-1)
    acq = permute_last(acq_zz, inverse_zigzag_order(8, 8)).reshape(3, nby, nbx, 8, 8)

    dc_step = dc_steps_t(distance)
    dc = dcq.astype(jnp.float32) * dc_step[:, None, None]

    eff_mul = effective_multiplier(qf_mul, acs)
    qsteps = steps_field(distance, acs, eff_mul)
    acf = acq.astype(jnp.float32)
    # v7 centroid reconstruction bias (transforms/quant.ac_recon_bias)
    acf = acf - (bias_on * ac_recon_bias()) * jnp.sign(acf)
    storage = acf * qsteps

    # Chroma-from-luma: add back the signaled per-tile luma prediction.
    yd = storage[1]
    kq = jnp.clip(cfl.astype(jnp.float32), -32, 32) / 32.0
    kb = jnp.repeat(jnp.repeat(kq, 4, axis=1), 4, axis=2)[:, :nby, :nbx]
    storage = jnp.stack(
        [
            storage[0] + kb[0][:, :, None, None] * yd,
            yd,
            storage[2] + kb[1][:, :, None, None] * yd,
        ]
    )

    blocks = _reconstruct_sub8(storage, dc, acs)
    planes = blocks.transpose(0, 1, 3, 2, 4).reshape(3, nby * 8, nbx * 8)
    if not skip_merged:
        for n, sid, _min_eff in MERGE_LADDER:
            planes = _overlay_merged(planes, storage, dc, acs, n, sid)
    if return_planes:
        return planes, eff_mul
    if epf:
        # decode_params bit 6 carries the stream's effective EPF flag
        # (config AND the encoder's per-image adaptive decision, v8) as a
        # TRACED bit: the filter is computed (cheap) and selected, so one
        # compiled decoder serves both outcomes and grid rows can mix them
        epf_on = ((params >> 6) & 1).astype(planes.dtype)
        planes = planes + epf_on * (epf_apply(planes, eff_mul, distance) - planes)
    planes = planes[:, :height, :width]

    x, y, b_res = planes[0], planes[1], planes[2]
    xyb = jnp.stack([x, y, b_res + y], axis=-1)
    srgb = xyb_to_srgb(xyb)
    return jnp.round(srgb * 255.0).astype(jnp.uint8)


def decode_stream_device(stream: JxtStream, route: str | None = None):
    """JxtStream -> RGB u8 [H, W, 3] as a DEVICE array.

    One packed host->device upload; the pixels stay on the device, where
    metrics and sweep consumers operate and fetch only scalars. route:
    the rANS decoder (default: this device's, triton_rans.decode_route).
    """
    from jxl_jax.entropy.grouped import MANT_SLACK, WORD_SLACK

    h = stream.header
    wcounts = stream.wcounts.astype(np.int64)
    mcounts = stream.mcounts.astype(np.int64)
    capw = _pow2_bucket(int(wcounts.max()) + WORD_SLACK if wcounts.size else 1)
    capm = _pow2_bucket(int(mcounts.max()) + MANT_SLACK if mcounts.size else 1)
    packed = _pack_stream_np(stream, capw, capm)

    return _decode_packed(
        jnp.asarray(packed),
        jnp.float32(h.distance),
        height=h.height,
        width=h.width,
        lanes=h.lanes,
        epf=True,  # traced decode_params bit 6 governs actual filtering
        capw=capw,
        capm=capm,
        route=route or _route(),
        lossless=h.lossless,
        palette=bool(h.lossless and len(stream.acs_extra) >= 3),
    )


def decode_stream_planes(stream: JxtStream):
    """JxtStream -> (pre-EPF padded XYB planes, eff_mul) device arrays.

    Building block of the striped gigapixel decoder (codec.tiled): stripes
    are stitched in plane space so EPF runs once, seam-exactly, over the
    whole image. Lossy streams only (d=0 stripes stitch as RGB)."""
    from jxl_jax.entropy.grouped import MANT_SLACK, WORD_SLACK

    h = stream.header
    wcounts = stream.wcounts.astype(np.int64)
    mcounts = stream.mcounts.astype(np.int64)
    capw = _pow2_bucket(int(wcounts.max()) + WORD_SLACK if wcounts.size else 1)
    capm = _pow2_bucket(int(mcounts.max()) + MANT_SLACK if mcounts.size else 1)
    packed = _pack_stream_np(stream, capw, capm)
    return _decode_packed(
        jnp.asarray(packed),
        jnp.float32(h.distance),
        height=h.height,
        width=h.width,
        lanes=h.lanes,
        epf=False,  # stripe stitching runs ONE seam-exact EPF afterwards
        capw=capw,
        capm=capm,
        route=_route(),
        lossless=False,
        return_planes=True,
    )


def _upload_hdr_u32(n_ctx: int) -> int:
    """u32 slots of the upload header before the states: params + packed
    cmap (4 u8/u32) + packed cluster tables (2 u16/u32, K_UP rows)."""
    from jxl_jax.entropy.tokens import ALPHABET

    k_up = min(64, n_ctx)
    return 1 + (-(-n_ctx // 4)) + k_up * (-(-ALPHABET // 2))


def _expand_freq(packed, n_ctx: int):
    """Device-side inverse of _pack_stream_np's clustered-table packing:
    returns freq [n_ctx, A] u32 (one tiny row gather — the expanded form
    would add ~160 KB to every v8 upload)."""
    from jxl_jax.entropy.tokens import ALPHABET

    cm = -(-n_ctx // 4)
    k_up = min(64, n_ctx)
    ta = -(-ALPHABET // 2)
    cmv = packed[1 : 1 + cm]
    cmap = jnp.stack(
        [(cmv >> (8 * j)) & 0xFF for j in range(4)], axis=1
    ).reshape(-1)[:n_ctx]
    tb = packed[1 + cm : 1 + cm + k_up * ta].reshape(k_up, ta)
    tables = jnp.stack([tb & 0xFFFF, tb >> 16], axis=2).reshape(k_up, -1)[
        :, :ALPHABET
    ]
    return tables[cmap.astype(jnp.int32)]


def _unpack_sections(p, n_ctx: int, lanes: int, capw: int, capm: int):
    """Device-side inverse of _pack_stream_np's dense payload packing:
    (states [lanes], words_g [G, capw], mant_g [G, capm]) u32. The u16
    words / u8 mantissa bytes arrive two/four per u32; a bitcast to the
    narrow type + reshape + widen re-expands them without a minor-dim
    strided interleave."""
    from jxl_jax.entropy.grouped import GROUP

    G = lanes // GROUP
    o = _upload_hdr_u32(n_ctx)
    states = p[o : o + lanes]
    o += lanes
    wp = p[o : o + G * (capw // 2)].reshape(G, capw // 2)
    mp = p[o + G * (capw // 2) : o + G * (capw // 2) + G * (capm // 4)].reshape(
        G, capm // 4
    )
    words_g = (
        jax.lax.bitcast_convert_type(wp, jnp.uint16)
        .reshape(G, capw)
        .astype(jnp.uint32)
    )
    mant_g = (
        jax.lax.bitcast_convert_type(mp, jnp.uint8)
        .reshape(G, capm)
        .astype(jnp.uint32)
    )
    return states, words_g, mant_g


def _pack_stream_np(stream: JxtStream, capw: int, capm: int) -> np.ndarray:
    """Build the single packed u32 upload buffer for one stream with the
    given (shared) per-group word/mantissa bucket sizes. Tables ride
    CLUSTERED (cmap + <= 64 rows, ~8 KB) instead of the [n_ctx, A]
    expansion (~160 KB at v8's 765 contexts); the device expands with one
    row gather (_expand_freq)."""
    from jxl_jax.entropy.grouped import GROUP
    from jxl_jax.entropy.tokens import ALPHABET

    h = stream.header
    G = h.lanes // GROUP
    words = np.frombuffer(stream.stream_words, dtype="<u2")
    mant = np.frombuffer(stream.mant_bytes, dtype=np.uint8)
    wcounts = stream.wcounts.astype(np.int64)
    mcounts = stream.mcounts.astype(np.int64)
    n_ctx = h.n_ctx
    cm = -(-n_ctx // 4)
    k_up = min(64, n_ctx)
    ta = -(-ALPHABET // 2)
    hdr = _upload_hdr_u32(n_ctx)
    # palette mode (lossless + non-empty extra section): 256 trailing u32
    # slots, one 0x00RRGGBB word per entry
    pal_u32 = 256 if (h.lossless and len(stream.acs_extra) >= 3) else 0
    packed = np.zeros(
        hdr + h.lanes + G * (capw // 2 + capm // 4) + pal_u32, dtype=np.uint32
    )
    if pal_u32:
        p = np.frombuffer(stream.acs_extra, np.uint8).reshape(-1, 3).astype(np.uint32)
        base = packed.shape[0] - 256
        packed[base : base + len(p)] = (p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]
    packed[0] = h.decode_params
    cmap = stream.cmap
    tables = stream.tables
    if cmap is None or tables is None or len(tables) > k_up:
        # hand-built streams without the clustered form: dedupe here
        tables, cmap = np.unique(
            np.asarray(stream.freq), axis=0, return_inverse=True
        )
        assert len(tables) <= k_up, "too many distinct tables for upload"
    cpad = np.zeros(cm * 4, np.uint32)
    cpad[:n_ctx] = np.asarray(cmap, np.uint32)
    cpad = cpad.reshape(-1, 4)
    packed[1 : 1 + cm] = (
        cpad[:, 0] | (cpad[:, 1] << 8) | (cpad[:, 2] << 16) | (cpad[:, 3] << 24)
    )
    tpad = np.zeros((k_up, ta * 2), np.uint32)
    tpad[: len(tables), :ALPHABET] = tables
    packed[1 + cm : 1 + cm + k_up * ta] = (
        tpad[:, 0::2] | (tpad[:, 1::2] << 16)
    ).reshape(-1)
    packed[hdr : hdr + h.lanes] = stream.states
    wsec = packed[hdr + h.lanes : hdr + h.lanes + G * (capw // 2)].reshape(
        G, capw // 2
    )
    mo = hdr + h.lanes + G * (capw // 2)
    msec = packed[mo : mo + G * (capm // 4)].reshape(G, capm // 4)
    wb = np.concatenate([[0], np.cumsum(wcounts)])
    mb = np.concatenate([[0], np.cumsum(mcounts)])
    for g in range(G):
        tmpw = np.zeros(capw, dtype="<u2")
        tmpw[: wcounts[g]] = words[wb[g] : wb[g + 1]]
        wsec[g] = tmpw.view("<u4")
        tmpm = np.zeros(capm, dtype=np.uint8)
        tmpm[: mcounts[g]] = mant[mb[g] : mb[g + 1]]
        msec[g] = tmpm.view("<u4")
    return packed


def decode_bytes_grid_stacked(datas, route: str | None = None):
    """Decode a whole RD-sweep row (list of container byte strings for the
    SAME image geometry) in ONE dispatch via `_decode_packed_grid`.

    Returns a STACKED [N, H, W, 3] device array — consumers should index
    it inside their own jitted programs (or fetch it whole): a host-side
    `out[i]` slice is a separate device op. Returns None when the row
    mixes geometries, lane counts, EPF settings, or contains lossless
    (d=0) points — callers fall back to per-stream decodes.
    """
    row = _pack_row(datas)
    if row is None or len(datas) < 2:
        return None
    packed, distances, kw = row
    return _decode_packed_grid(
        jnp.asarray(packed), jnp.asarray(distances), epf=True,
        route=route or _route(), **kw
    )


def _pack_row(datas):
    """Containers of one geometry -> (packed [N, L] u32, distances [N] f32,
    static decode kwargs), or None when the row mixes geometries, lane
    counts or lossless/lossy, or holds palette streams (those need the
    per-stream palette gather). EPF may differ per point: the traced
    decode_params bit governs it."""
    from jxl_jax.entropy.grouped import MANT_SLACK, WORD_SLACK

    streams = [read_container(b) for b in datas]
    h0 = streams[0].header
    if not all(
        s.header.height == h0.height
        and s.header.width == h0.width
        and s.header.lanes == h0.lanes
        and s.header.lossless == h0.lossless
        and not (s.header.lossless and len(s.acs_extra) >= 3)
        for s in streams
    ):
        return None
    capw = _pow2_bucket(max(int(s.wcounts.max()) for s in streams) + WORD_SLACK)
    capm = _pow2_bucket(max(int(s.mcounts.max()) for s in streams) + MANT_SLACK)
    packed = np.stack([_pack_stream_np(s, capw, capm) for s in streams])
    distances = np.asarray([s.header.distance for s in streams], np.float32)
    kw = dict(
        height=h0.height, width=h0.width, lanes=h0.lanes, capw=capw, capm=capm,
        lossless=h0.lossless,
    )
    return packed, distances, kw


_rans_values_jit = partial(
    jax.jit,
    static_argnames=("height", "width", "lanes", "capw", "capm", "route", "lossless"),
)(_rans_values)


def decode_rans_row(datas, route: str):
    """The rANS stage alone for a row of same-geometry containers, on the
    given route: numpy (values [N, T*lanes], carry_a, carry_b), carries as
    in _rans_values. Comparing routes checks the kernel against its XLA
    twin bit for bit: states, pointers and symbols are integers."""
    row = _pack_row(datas)
    if row is None:
        raise ValueError("containers of one geometry and mode expected")
    packed, _distances, kw = row
    vals, _params, carry_a, carry_b = jax.device_get(
        _rans_values_jit(jnp.asarray(packed), route=route, **kw)
    )
    return vals, carry_a, carry_b


def decode_bytes_grid_device(datas):
    """List-of-device-arrays view of decode_bytes_grid_stacked (each
    element is a slice op, a dispatch each; hot paths use the stacked form
    directly)."""
    out = decode_bytes_grid_stacked(datas)
    if out is None:
        return [decode_stream_device(read_container(b)) for b in datas]
    return [out[i] for i in range(out.shape[0])]


def decode_stream(stream: JxtStream) -> np.ndarray:
    """JxtStream -> RGB u8 [H, W, 3] (host array)."""
    return np.asarray(jax.device_get(decode_stream_device(stream)))


def decode_bytes(data: bytes) -> np.ndarray:
    if data[:4] == b"JXTS":  # striped gigapixel container (codec.tiled)
        from jxl_jax.codec.tiled import decode_striped_bytes

        return decode_striped_bytes(data)
    return decode_stream(read_container(data))


def decode_bytes_device(data: bytes):
    """Decode to a device-resident RGB u8 array (no device->host download)."""
    return decode_stream_device(read_container(data))


def decode_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_bytes(f.read())
