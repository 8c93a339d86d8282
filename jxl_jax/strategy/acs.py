"""AC-strategy search: variable DCT block sizes, selected densely under jit.

On-device counterpart of libjxl's `ProcessRectACS`/`FindBest8x8Transform`/
`TryMergeAcs`/`FindBestFirstLevelDivisionForSquare` (the functions the thesis
patches — SURVEY §3.4): where the C++ walks 64x64 tiles with branchy
per-block recursion, this computes *every* candidate transform for *every*
block as batched matmuls, scores them all at once, and selects by masked
argmin — the dense-then-select pattern SURVEY §7 "hard parts #3" prescribes
for data-dependent strategy choice under jit.

Strategies and their coefficient storage in the per-8x8-block [8, 8] grid:

| id | name     | transform(s)        | storage layout                       |
|----|----------|---------------------|--------------------------------------|
| 0  | DCT      | one 8x8             | coefficients, (0,0) = 0 (DC plane)   |
| 1  | DCT4X4   | four 4x4            | quadrant (qy,qx) at [4qy:, 4qx:];    |
|    |          |                     | sub-DCs Haar-mixed: M=dct2(subDCs),  |
|    |          |                     | M00 == block DC (DC plane), M01/M10/ |
|    |          |                     | M11 stored at the other quadrant DCs |
| 2  | DCT8X4   | two 8rows x 4cols   | halves at cols [0:4], [4:8];         |
|    |          |                     | (s0+s1)/sqrt2 == DC, (s0-s1)/sqrt2   |
|    |          |                     | stored at (0,4)                      |
| 3  | DCT4X8   | two 4rows x 8cols   | mirror of DCT8X4; m1 at (4,0)        |
| 4  | DCT16X16 | one 16x16 over 2x2  | C16 8x8 quadrants in the 4 blocks;   |
|    |          | aligned blocks      | C16[:2,:2] not coded (rebuilt from   |
|    |          |                     | the DC plane via dct2 at decode)     |
| 5  | DCT32X32 | one 32x32 over 4x4  | same scheme, C32[:4,:4] from DC      |
| 6  | DCT64X64 | one 64x64 over 8x8  | same scheme, C64[:8,:8] from DC      |
| 7  | DCT128X128 | 128x128 over 16x16| same scheme, C128[:16,:16] from DC   |
| 8  | DCT256X256 | 256x256 over 32x32| same scheme (libjxl's largest        |
|    |          |                     | transform = one full 256x256 group)  |

All strategies keep the invariant: the DC-plane entry of every 8x8 block is
its exact pixel mean * 8, so DC prediction/coding is strategy-independent.

Step grids are NOT a flat variant table (256x256 alone would need 1024
variant rows and a [nb, 1024] one-hot select): the per-block step field is
assembled from one periodic tiling per size class (`steps_field`) — a
handful of masked selects over tiny tables, XLA-fusible at any image size.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp
import numpy as np

from jxl_jax.strategy.homogeneity import (
    homogeneity_partition,
    homogeneity_similarity_indices,
    hook_b_factor,
)
from jxl_jax.transforms.dct import dct2d, idct2d
from jxl_jax.transforms.quant import ac_steps_t

ACS_DCT = 0
ACS_DCT4X4 = 1
ACS_DCT8X4 = 2
ACS_DCT4X8 = 3
ACS_DCT16X16 = 4
ACS_DCT32X32 = 5
ACS_DCT64X64 = 6
ACS_DCT128X128 = 7
ACS_DCT256X256 = 8
N_STRATEGIES = 9

SQRT2 = float(np.sqrt(2.0))

# The square-merge ladder: (pixel size, strategy id, minimum effort). The
# effort gating mirrors cjxl's: bigger transforms cost more search, so they
# arrive at higher --effort (reference grid sweeps e5..9, benchmark.rs:638).
# 256x256 = one full libjxl group, the largest transform the spec has.
MERGE_LADDER = (
    (16, ACS_DCT16X16, 6),
    (32, ACS_DCT32X32, 7),
    (64, ACS_DCT64X64, 7),
    (128, ACS_DCT128X128, 8),
    (256, ACS_DCT256X256, 9),
)

# Entropy multipliers (cost handicap per strategy; <1 favors, >1 penalizes).
# Splits must clearly win to be chosen; merges are slightly favored on
# smooth content — mirroring the role of libjxl's per-transform entropy_mul.
ENTROPY_MUL = {
    ACS_DCT: 1.0,
    ACS_DCT4X4: 1.12,
    ACS_DCT8X4: 1.08,
    ACS_DCT4X8: 1.08,
    ACS_DCT16X16: 0.99,
    ACS_DCT32X32: 0.98,
    ACS_DCT64X64: 0.97,
    ACS_DCT128X128: 0.96,
    ACS_DCT256X256: 0.95,
}

# Rate proxy constants: bits(q) ~ 2*log2(1+|q|) + NONZERO_BITS per nonzero.
NONZERO_BITS = 1.1


def log2_1p_fast(aq: jnp.ndarray) -> jnp.ndarray:
    """log2(1 + aq) for aq >= 0 via the float32 exponent trick.

    bitcast(1 + aq) read as an integer is 2^23 * (127 + log2-ish): exact at
    powers of two, piecewise-linear in the mantissa between (max error
    0.086, mean 0.043 — corrected here). The rate PROXIES are the hottest
    transcendental consumers in the encoder (4 dense sub-8 candidates x
    3 ch x 64 coeffs, plus 2 RDO candidates = ~7M log2 calls per 0.4 MP
    image); a bitcast + multiply replaces each VPU transcendental. Rate
    models remain proxies — the approximation error is far below the model
    error — but decisions can flip on near-ties, so this is encoder-only
    (no decoder mirror needed)."""
    import jax

    v = aq.astype(jnp.float32) + 1.0
    bits = jax.lax.bitcast_convert_type(v, jnp.int32)
    # The exponent+mantissa value e+m UNDERestimates log2(1+aq) by
    # [0, 0.086] bits (mean 0.058), so the centering correction must be
    # ADDED: subtract 126.95, not 127.043 (the old subtrahend doubled the
    # bias instead of cancelling it). The max(..., 0) clamp
    # keeps log2(1+0) exactly 0 so all-zero candidates' rates never go
    # negative and ENTROPY_MUL tie-breaks on flat content hold.
    return jnp.maximum(bits.astype(jnp.float32) * (1.0 / (1 << 23)) - 126.95, 0.0)


def sub8_step_grids(distance) -> jnp.ndarray:
    """[4, 3, 8, 8] quant-step grids on the 8x8 storage layout for the
    sub-8 strategies (DCT, DCT4X4, DCT8X4, DCT4X8).

    No per-size step scaling: all transforms are orthonormal and cover the
    same number of coefficients per pixel area, so equal steps give equal
    quantization MSE (Parseval) — candidates then compete purely on rate
    (energy compaction). The CSF frequency weight is indexed by normalized
    frequency u/n, which is cycles/pixel, hence directly comparable across
    sizes.

    `distance` may be a traced scalar: the tables are tiny and recomputing
    them per call keeps the whole codec distance-polymorphic under one jit
    compilation.
    """
    u = np.arange(8)
    s8 = ac_steps_t(distance, 8, 8)
    s4 = ac_steps_t(distance, 4, 4)[:, u[:, None] % 4, u[None, :] % 4]
    s84 = ac_steps_t(distance, 8, 4)[:, u[:, None], u[None, :] % 4]
    s48 = ac_steps_t(distance, 4, 8)[:, u[:, None] % 4, u[None, :]]
    return jnp.stack([s8, s4, s84, s48])


def merged_step_slots(distance, n: int) -> jnp.ndarray:
    """[3, k, k, 8, 8] per-sub-block step grids of the n x n transform
    (k = n//8) in the same STRIDED mapping as candidates_merged:
    slot (ky, kx)[u, v] = S[u*k + ky, v*k + kx]."""
    k = n // 8
    s = ac_steps_t(distance, n, n)
    return s.reshape(3, 8, k, 8, k).transpose(0, 2, 4, 1, 3)


def _rate_bits(q: jnp.ndarray, axes) -> jnp.ndarray:
    """Rate proxy in bits over the given axes (q: int32 quantized coeffs)."""
    aq = jnp.abs(q).astype(jnp.float32)
    return jnp.sum(2.0 * log2_1p_fast(aq) + NONZERO_BITS * (aq > 0), axis=axes)


def _rate_bits_lut(q: jnp.ndarray, bit_lut: jnp.ndarray, axes) -> jnp.ndarray:
    """MEASURED rate in bits: per coefficient, the actual rANS cost of its
    hybrid-uint token under the image's own histograms plus its mantissa
    bits. bit_lut: [3, 8, 8, A] (storage position -> per-symbol bits, from
    encode._bits_lut_grid). q: [..., 3, y, x, (k, k,) 8, 8] — the LUT
    broadcasts over the middle axes. The one-hot reduce fuses (iota-compare
    feeding a reduction never materializes in XLA)."""
    from jxl_jax.entropy.tokens import ALPHABET, tokenize, zigzag_map

    sym, _, _ = tokenize(zigzag_map(q))
    a = jnp.arange(ALPHABET, dtype=jnp.int32)
    oh = (sym[..., None] == a).astype(jnp.float32)
    # reshape LUT to broadcast against q's shape: [3, 1.., 8, 8, A]
    extra = q.ndim - 3  # middle axes between channel and the 8x8
    lut = bit_lut.reshape((3,) + (1,) * extra + (8, 8, ALPHABET))
    per_coeff = jnp.sum(oh * lut, axis=-1)
    return jnp.sum(per_coeff, axis=axes)


def _mask_dc_slot(storage: jnp.ndarray) -> jnp.ndarray:
    """Zero the (0,0) slot (DC lives in the DC plane for every strategy)."""
    return storage.at[..., 0, 0].set(0.0)


def candidates_sub8(blocks: jnp.ndarray) -> dict:
    """Per-block coefficient storages for strategies 0..3.

    blocks: [3, nby, nbx, 8, 8] pixel blocks (XYB planes).
    Returns dict id -> storage [3, nby, nbx, 8, 8] float32 (DC slot zeroed,
    Haar-mixed sub-DC slots filled per the layout table).
    """
    c8 = dct2d(blocks)

    # DCT4X4: quadrants
    q = blocks.reshape(*blocks.shape[:-2], 2, 4, 2, 4).transpose(0, 1, 2, 3, 5, 4, 6)
    c44 = dct2d(q)  # [3, nby, nbx, 2, 2, 4, 4]
    subdc = c44[..., 0, 0]  # [3, nby, nbx, 2, 2]
    m = dct2d(subdc)  # orthonormal 2x2 DCT of the sub-DC matrix
    st44 = c44.transpose(0, 1, 2, 3, 5, 4, 6).reshape(*blocks.shape[:-2], 8, 8)
    st44 = st44.at[..., 0, 0].set(0.0)  # M00 == DC -> DC plane
    st44 = st44.at[..., 0, 4].set(m[..., 0, 1])
    st44 = st44.at[..., 4, 0].set(m[..., 1, 0])
    st44 = st44.at[..., 4, 4].set(m[..., 1, 1])

    # DCT8X4: left/right halves (8 rows x 4 cols each)
    halves = blocks.reshape(*blocks.shape[:-2], 8, 2, 4).transpose(0, 1, 2, 4, 3, 5)
    c84 = dct2d(halves)  # [3, nby, nbx, 2, 8, 4]
    s0, s1 = c84[..., 0, 0, 0], c84[..., 1, 0, 0]
    st84 = c84.transpose(0, 1, 2, 4, 3, 5).reshape(*blocks.shape[:-2], 8, 8)
    st84 = st84.at[..., 0, 0].set(0.0)  # (s0+s1)/sqrt2 == DC
    st84 = st84.at[..., 0, 4].set((s0 - s1) / SQRT2)

    # DCT4X8: top/bottom halves (4 rows x 8 cols each)
    halvesv = blocks.reshape(*blocks.shape[:-2], 2, 4, 8)
    c48 = dct2d(halvesv)  # [3, nby, nbx, 2, 4, 8]
    t0, t1 = c48[..., 0, 0, 0], c48[..., 1, 0, 0]
    st48 = c48.reshape(*blocks.shape[:-2], 8, 8)
    st48 = st48.at[..., 0, 0].set(0.0)
    st48 = st48.at[..., 4, 0].set((t0 - t1) / SQRT2)

    return {
        ACS_DCT: _mask_dc_slot(c8),
        ACS_DCT4X4: st44,
        ACS_DCT8X4: st84,
        ACS_DCT4X8: st48,
    }


def candidates_merged(planes: jnp.ndarray, n: int) -> jnp.ndarray:
    """n x n DCT (n in {16..256}) over aligned groups.

    planes: [3, Hp, Wp] with Hp, Wp multiples of 8. Returns storage slots
    [3, gby, gbx, k, k, 8, 8] (k = n//8) in the STRIDED (decimated)
    coefficient mapping: slot (ky, kx)[u, v] = C[u*k + ky, v*k + kx].

    Why strided, not contiguous 8x8 tiles: the token layout codes only
    zigzag positions 1..63 of every block's storage — each sub-block's
    (0, 0) slot is NEVER coded (the DC plane stands in for it). Under the
    strided map the k x k (0, 0) slots are exactly C[:k, :k], the
    low-frequency corner the decoder rebuilds from the DC plane — so
    nothing real is dropped (a contiguous-tile map would silently zero the
    k^2 - 1 coefficients C[8ky, 8kx]). It also makes each slot's (u, v)
    approximate the same normalized frequency as an 8x8 block's (u, v),
    so the zigzag-band entropy contexts stay meaningful for merged blocks
    — this is the same reasoning behind libjxl's scattered coefficient
    storage for big transforms.
    """
    k = n // 8
    h, w = planes.shape[-2:]
    gby, gbx = h // n, w // n
    region = planes[:, : gby * n, : gbx * n]
    tiles = region.reshape(3, gby, n, gbx, n).transpose(0, 1, 3, 2, 4)
    c = dct2d(tiles)  # [3, gby, gbx, n, n]
    c = c.at[..., :k, :k].set(0.0)  # lowfreq rebuilt from DC plane at decode
    return c.reshape(3, gby, gbx, 8, k, 8, k).transpose(0, 1, 2, 4, 6, 3, 5)


def reassemble_merged(slots: jnp.ndarray, dc_block: jnp.ndarray) -> jnp.ndarray:
    """Inverse of candidates_merged + lowfreq injection.

    slots: [3, gby, gbx, k, k, 8, 8] dequantized storages (strided map),
    dc_block: [3, gby, gbx, k, k] dequantized DC-plane values of the group.
    Returns pixel tiles [3, gby, gbx, n, n].
    """
    k = slots.shape[3]
    n = k * 8
    c = slots.transpose(0, 1, 2, 5, 3, 6, 4).reshape(*slots.shape[:3], n, n)
    llf = dct2d(dc_block)  # [3, gby, gbx, k, k]
    c = c.at[..., :k, :k].set(llf)
    return idct2d(c)


def group_min_multiplier(qf_mul: jnp.ndarray, k: int) -> jnp.ndarray:
    """Min-pool the per-block multiplier over aligned k x k groups and
    broadcast back — the deterministic rule (shared by encoder and decoder)
    for the multiplier of merged transforms: conservative minimum."""
    nby, nbx = qf_mul.shape
    gby, gbx = nby // k, nbx // k
    if gby == 0 or gbx == 0:
        return qf_mul
    pooled = qf_mul[: gby * k, : gbx * k].reshape(gby, k, gbx, k).min(axis=(1, 3))
    up = jnp.repeat(jnp.repeat(pooled, k, axis=0), k, axis=1)
    return jnp.pad(up, ((0, nby - gby * k), (0, nbx - gbx * k)), constant_values=1.0)


def search_acs(
    blocks: jnp.ndarray,
    planes: jnp.ndarray,
    distance: float,
    *,
    effort: int,
    hook_a: bool,
    hook_b: bool,
    qf_mul: jnp.ndarray | None = None,
    bit_lut: jnp.ndarray | None = None,
):
    """Full AC-strategy search. Returns (acs [nby, nbx] int32,
    storage [3, nby, nbx, 8, 8] float32 of the selected strategies,
    qsteps [3, nby, nbx, 8, 8] step field).

    Hooks implement the thesis variants (SURVEY §2.4):
    - hook A: where the 8x8-level argmin picked plain DCT, override with
      HomogeneityPartition (homogeneity-partitioning.diff:272-277).
    - hook B: scale every candidate cost by 0.8*avg(r_h,r_v,r_d) of the
      candidate's top-left 8x8 block (factored-entropy.diff:248-254); at the
      8x8 level the factor is common to all candidates so — exactly like the
      C++ — it bites on merge decisions.

    bit_lut (efforts >= 8, see encode.tokens_from_rgb): replaces the
    2*log2(1+|q|) proxy with MEASURED per-symbol rANS bit costs from the
    image's own first-pass histograms — the libjxl-style two-pass rate
    model the round-1 review asked for.
    """
    rate = (
        _rate_bits
        if bit_lut is None
        else partial(_rate_bits_lut, bit_lut=bit_lut)
    )
    nby, nbx = blocks.shape[1], blocks.shape[2]
    sub8_steps = sub8_step_grids(distance)
    if qf_mul is None:
        qf_mul = jnp.ones((nby, nbx), jnp.float32)

    if hook_a or hook_b:
        r_h, r_v, r_d = homogeneity_similarity_indices(planes, distance)
    if hook_b:
        bfac = hook_b_factor(r_h, r_v, r_d)  # [nby, nbx]
    else:
        bfac = None

    sub8 = candidates_sub8(blocks)
    costs = {}
    qcands = {}
    for sid, storage in sub8.items():
        steps = sub8_steps[sid][:, None, None] * qf_mul[None, :, :, None, None]
        qc = jnp.round(storage / steps).astype(jnp.int32)
        qcands[sid] = qc
        c = rate(qc, axes=(0, -2, -1)) * ENTROPY_MUL[sid]  # [nby, nbx]
        if hook_b:
            c = c * 0.8 * bfac
        costs[sid] = c

    if effort >= 4:
        stacked = jnp.stack([costs[s] for s in range(4)])
        best8 = jnp.argmin(stacked, axis=0).astype(jnp.int32)
    else:
        best8 = jnp.zeros((nby, nbx), jnp.int32)

    # Merge comparisons use the PRE-override entropy, like the C++: in
    # FindBest8x8Transform *entropy_out is stored before HomogeneityPartition
    # rewrites best_tx (homogeneity-partitioning.diff:271-277).
    cost_sel = jnp.take_along_axis(
        jnp.stack([costs[s] for s in range(4)]), best8[None], axis=0
    )[0]

    if hook_a:
        part = homogeneity_partition(r_h, r_v, r_d, distance)
        override = best8 == ACS_DCT
        if hook_a == 2:
            # RD-GATED variant: only override where
            # the partition's candidate is within epsilon of the dense
            # argmin's winner in measured proxy rate — the near-tie the
            # proxy can't rank, which is exactly where the round-4
            # 600-point A/B found the thesis heuristic pays (text:
            # +0.123 dB). Unconditional override (hook_a == 1) loses
            # everywhere else because the argmin already measured the
            # partition's rate and rejected it.
            import os

            # read at TRACE time like every JXL_JAX_* knob (see
            # transforms/quant.py): changing it mid-process does not
            # invalidate already-compiled encoder programs — set it
            # before the first encode of a given (shape, effort) config
            eps = float(os.environ.get("JXL_JAX_HOOKA_EPS", "0.02"))
            stackc = jnp.stack([costs[s] for s in range(4)])
            cost_part = jnp.take_along_axis(stackc, part[None], axis=0)[0]
            override = override & (cost_part <= cost_sel * (1.0 + eps))
        best8 = jnp.where(override, part, best8)

    acs = best8

    def try_merge(acs, cost_sel, n, sid):
        k = n // 8
        gby, gbx = nby // k, nbx // k
        if gby == 0 or gbx == 0:
            return acs, cost_sel, None, None
        slots = candidates_merged(planes, n)  # [3, gby, gbx, k, k, 8, 8]
        step_slots = merged_step_slots(distance, n)[:, None, None]  # [3,1,1,k,k,8,8]
        gmul = group_min_multiplier(qf_mul, k)[: gby * k : k, : gbx * k : k]
        qslots = jnp.round(
            slots / (step_slots * gmul[None, :, :, None, None, None, None])
        ).astype(jnp.int32)
        cost_m = rate(qslots, axes=(0, -4, -3, -2, -1)) * ENTROPY_MUL[sid]
        if hook_b:
            bf_g = bfac[: gby * k : k, : gbx * k : k]  # top-left block factor
            cost_m = cost_m * 0.8 * bf_g
        # current cost of the group = sum of selected per-block costs;
        # epsilon breaks zero-cost ties toward the merge (bigger transforms
        # win on content they represent equally cheaply, e.g. flat areas)
        cur = cost_sel[: gby * k, : gbx * k].reshape(gby, k, gbx, k).sum(axis=(1, 3))
        merge = cost_m < cur + 1e-3  # [gby, gbx]
        merge_blocks = jnp.repeat(jnp.repeat(merge, k, axis=0), k, axis=1)
        pad_y, pad_x = nby - gby * k, nbx - gbx * k
        merge_full = jnp.pad(merge_blocks, ((0, pad_y), (0, pad_x)))
        acs = jnp.where(merge_full, sid, acs)
        new_cost = jnp.repeat(jnp.repeat(cost_m / (k * k), k, axis=0), k, axis=1)
        cost_sel = jnp.where(merge_full, jnp.pad(new_cost, ((0, pad_y), (0, pad_x))), cost_sel)
        return acs, cost_sel, slots, merge

    merged = []  # (slots, merge mask, n, sid) per attempted ladder rung
    for n, sid, min_eff in MERGE_LADDER:
        if effort >= min_eff:
            acs, cost_sel, slots, merge = try_merge(acs, cost_sel, n, sid)
            if slots is not None:
                merged.append((slots, merge, n, sid))

    # Assemble the selected RAW coefficient storage by per-block masked
    # select (wheres, not take_along_axis: they fuse, a gather does not). The
    # caller quantizes — identically to the candidate costs' quantization —
    # after optionally applying chroma-from-luma on the raw values.
    sel = jnp.clip(acs, 0, 3)[None, :, :, None, None]
    raw = sub8[0]
    for s in range(1, 4):
        raw = jnp.where(sel == s, sub8[s], raw)

    def scatter_merged(storage, slots, merge, n):
        k = n // 8
        gby, gbx = merge.shape
        mb = jnp.repeat(jnp.repeat(merge, k, axis=0), k, axis=1)
        mb = jnp.pad(mb, ((0, nby - gby * k), (0, nbx - gbx * k)))
        # slots [3, gby, gbx, k, k, 8, 8] -> block grid [3, gby*k, gbx*k, 8, 8]
        qs = slots.transpose(0, 1, 3, 2, 4, 5, 6).reshape(3, gby * k, gbx * k, 8, 8)
        qs = jnp.pad(qs, ((0, 0), (0, nby - gby * k), (0, nbx - gbx * k), (0, 0), (0, 0)))
        return jnp.where(mb[None, :, :, None, None], qs, storage)

    for slots, merge, n, sid in merged:
        k = n // 8
        gby, gbx = merge.shape
        # guard by the FINAL acs map: a later (bigger) rung may have
        # overridden this rung's merge decision
        origin_is = acs[: gby * k : k, : gbx * k : k] == sid
        raw = scatter_merged(raw, slots, jnp.logical_and(merge, origin_is), n)

    qsteps = steps_field(distance, acs, effective_multiplier(qf_mul, acs))
    return acs, raw, qsteps


def steps_field(distance, acs: jnp.ndarray, eff_mul: jnp.ndarray) -> jnp.ndarray:
    """[3, nby, nbx, 8, 8] per-block quant-step field.

    One periodic tiling per size class + masked selects: for a merged size
    n (k = n//8), block (by, bx) of an aligned group holds sub-tile
    (by %% k, bx %% k) of the n x n step table — a static function of
    position, so the whole class field is one jnp.tile of the [3, k, k,
    8, 8] table. The selects fuse into a single elementwise pass; nothing
    scales with a variant count (the 256x256 class alone would need 1024
    rows in a flat table)."""
    nby, nbx = acs.shape
    sel = acs[None, :, :, None, None]
    sub8 = sub8_step_grids(distance)
    field = jnp.broadcast_to(sub8[0][:, None, None], (3, nby, nbx, 8, 8))
    for s in (ACS_DCT4X4, ACS_DCT8X4, ACS_DCT4X8):
        field = jnp.where(sel == s, sub8[s][:, None, None], field)
    for n, sid, _min_eff in MERGE_LADDER:
        k = n // 8
        if nby < k or nbx < k:
            continue  # merged id can't occur in a smaller image
        g = merged_step_slots(distance, n)  # [3, k, k, 8, 8]
        ry, rx = -(-nby // k), -(-nbx // k)
        t = jnp.tile(g, (1, ry, rx, 1, 1))[:, :nby, :nbx]
        field = jnp.where(sel == sid, t, field)
    return field * eff_mul[None, :, :, None, None]


def effective_multiplier(qf_mul: jnp.ndarray, acs: jnp.ndarray) -> jnp.ndarray:
    """Per-block step multiplier given the quant field and strategy map:
    merged transforms take the group-minimum (same rule on both codec sides)."""
    eff = qf_mul
    for n, sid, _min_eff in MERGE_LADDER:
        eff = jnp.where(acs == sid, group_min_multiplier(qf_mul, n // 8), eff)
    return eff
