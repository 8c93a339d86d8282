"""Static token/context layout — shared encoder/decoder ground truth.

The decoder must know each token's entropy context *before* decoding it.
For the map/DC sections contexts are a pure function of the (static) image
geometry; for the AC section (container v8) the context additionally
conditions on a per-(channel, block) NONZERO-COUNT BUCKET that is itself
signaled in an earlier section — the on-device analog of libjxl's
num-nonzeros-conditioned AC histograms. Decoding is
therefore two-phase: the static-context sections decode first, the bucket
map comes out, and the AC scan's per-step contexts are computed on device
from it (codec/decode.py).

Token stream order (flat index -> meaning):
  [0, nb)            AC-strategy map tokens ([nby, nbx], ids 0..5)
  [nb, 2*nb)         quant-field multiplier indices ([nby, nbx], 0..15)
  [.., +2*ntiles)    chroma-from-luma factors, zigzag-mapped ([2, ty, tx])
  [.., +3*nb)        nnz-bucket map ([3, nby, nbx], values 0..NNZ_Q-1)
  [.., +3*nb)        DC residual tokens, channel-major ([3, nby, nbx])
  [.., end)          AC tokens, [3, 63, nb]: zigzag-position-major, block
                     axis PERMUTED per channel by a stable sort on the
                     bucket map (all-zero blocks first-class: their steps
                     get a degenerate table and code at ~0 bits)

The z-major AC order makes the context id sequence a list of long runs.
`padded_layout` pads every SPAN (section / channel x band segment) to a
multiple of the rANS lane count K, so that each K-token scan step has a
SINGLE context: the decoder then streams one (freq, cum) table row per
step instead of doing a per-token table gather — the key property the
Pallas rANS kernel (entropy/pallas_rans.py) relies on. Within an AC span
the per-step context (channel, zigzag position, bucket) is data-dependent
and computed identically by encoder and decoder (`ac_step_meta` below);
a step straddling a position/bucket boundary takes its FIRST token's
context (both sides agree, so coding stays consistent; the handful of
boundary tokens code under a neighboring — statistically similar — table).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from jxl_jax.transforms.dct import zigzag_order

# AC band split by zigzag position (1-indexed after DC): dyadic bands
# 1, 2-3, 4-7, 8-15, 16-31, 32-63. Bands define the K-padding SPANS; the
# coding context is finer (per position x bucket, see below).
_BAND_EDGES = (2, 4, 8, 16, 32)
N_BANDS = len(_BAND_EDGES) + 1

# nnz-bucket count and edges: bucket(nnz) = #edges <= nnz. Measured on the
# committed corpus (tools/combo_study.py): 4 buckets with edges (1, 3, 8)
# capture ~all of the conditioning win (graphics-family AC bits -30%,
# photo-family -4..-7% together with the per-position contexts).
NNZ_Q = 4
NNZ_EDGES = (1, 3, 8)

# Context ids: 0-2 DC (X, Y, B), 3 ACS map, 4 QF map, 5 CfL, 6-8 nnz map
# (X, Y, B), 9.. AC: 9 + (bucket * 3 + c) * 63 + (p - 1) — bucket-MAJOR so
# the container's cluster map runs along zigzag position within one
# (bucket, channel) stripe, where neighboring positions share a cluster
# (long RLE runs; bucket-minor ids interleave 4 different clusters).
CTX_ACS = 3
CTX_QF = 4
CTX_CFL = 5
CTX_NNZ = 6  # .. 8
CTX_AC_BASE = 9
N_CTX = CTX_AC_BASE + 3 * 63 * NNZ_Q  # 765
CFL_TILE = 4  # chroma-from-luma tile size in 8x8 blocks (32x32 pixels)


@lru_cache(maxsize=None)
def ac_band_table() -> np.ndarray:
    """[63] band index for zigzag positions 1..63."""
    pos = np.arange(1, 64)
    band = np.zeros(63, np.int32)
    for e in _BAND_EDGES:
        band += (pos >= e).astype(np.int32)
    return band


@lru_cache(maxsize=None)
def token_layout(height: int, width: int):
    """Geometry + context ids for an image. Returns a dict of python ints and
    numpy arrays (safe to capture as jit constants).

    `ctx` holds per-token context ids with AC buckets as 0 — the layout's
    STATIC view (what the stream codes when the encoder decides bucket
    conditioning does not pay and writes a zero map). The bucket-conditioned
    ids are the static ids plus NNZ_Q-strided offsets computed on device
    (`ac_step_meta` in padded_layout)."""
    hp = -(-height // 8) * 8
    wp = -(-width // 8) * 8
    nby, nbx = hp // 8, wp // 8
    nb = nby * nbx
    n_acs = nb
    n_qf = nb
    ty, tx = -(-nby // CFL_TILE), -(-nbx // CFL_TILE)
    n_cfl = 2 * ty * tx
    n_nnz = 3 * nb
    n_dc = 3 * nb
    n_ac = 3 * nb * 63
    n_tokens = n_acs + n_qf + n_cfl + n_nnz + n_dc + n_ac

    band = ac_band_table()  # [63] band per zigzag position, z-major runs
    # runs: (ctx, length) in stream order. AC runs are (channel x band)
    # SPANS for K-padding purposes; their nominal ctx id is the bucket-0
    # context of the span's first zigzag position (real per-step ids are
    # computed from the nnz map).
    runs = [(CTX_ACS, n_acs), (CTX_QF, n_qf), (CTX_CFL, n_cfl)]
    runs += [(CTX_NNZ + c, nb) for c in range(3)]
    runs += [(c, nb) for c in range(3)]  # DC
    band_start = []  # first zigzag position (1-indexed) of each band
    for b in range(N_BANDS):
        band_start.append(int(np.argmax(band == b)) + 1)
    for c in range(3):
        for b in range(N_BANDS):
            nominal = CTX_AC_BASE + c * 63 + (band_start[b] - 1)
            runs.append((nominal, int(np.sum(band == b)) * nb))
    # static per-token ctx (AC buckets = 0): AC tokens are z-major, so the
    # per-position ids repeat nb times each.
    ac_pos_ctx = np.repeat(
        CTX_AC_BASE + np.arange(3 * 63, dtype=np.int32), nb
    )
    ctx = np.concatenate(
        [
            np.full(n_acs, CTX_ACS, np.int32),
            np.full(n_qf, CTX_QF, np.int32),
            np.full(n_cfl, CTX_CFL, np.int32),
            np.repeat(np.arange(CTX_NNZ, CTX_NNZ + 3, dtype=np.int32), nb),
            np.repeat(np.arange(3, dtype=np.int32), nb),
            ac_pos_ctx,
        ]
    )
    zz = zigzag_order(8, 8)  # [64] flat indices, zz[0] == 0 (DC)

    return {
        "runs": runs,
        "hp": hp,
        "wp": wp,
        "nby": nby,
        "nbx": nbx,
        "nb": nb,
        "n_acs": n_acs,
        "n_qf": n_qf,
        "n_cfl": n_cfl,
        "n_nnz": n_nnz,
        "ty": ty,
        "tx": tx,
        "n_dc": n_dc,
        "n_ac": n_ac,
        "n_tokens": n_tokens,
        "n_ctx": N_CTX,
        "ctx": ctx,
        "zigzag": zz,
    }


def _pad_runs(runs, lanes: int):
    """Common span/step-context builder: pad every (ctx, n) run to a
    multiple of `lanes` so each K-token scan step has a single context."""
    spans = []
    dst = 0
    step_ctx = []
    for c, n in runs:
        n_pad = -(-n // lanes) * lanes
        spans.append((c, dst, n, n_pad))
        step_ctx += [c] * (n_pad // lanes)
        dst += n_pad
    return spans, dst, np.asarray(step_ctx, dtype=np.int32)


# lossless per-8x8-block activity classes: 0 = all residuals zero (the
# block codes at ~0 bits through the degenerate-table trick), 1 = sparse,
# 2 = busy. Edges on the nonzero count of the 64 residuals.
LL_Q = 3
LL_EDGES = (1, 33)


@lru_cache(maxsize=None)
def lossless_layout(height: int, width: int, lanes: int):
    """Token layout for the lossless modular mode (v8): a per-(channel,
    8x8 block) activity-flag section decoded first, then the three
    residual planes 8-padded, BLOCK-major, with the block axis sorted by
    activity class — the same two-phase conditioning the lossy AC path
    uses (flat blocks cluster into a pure-zero context and code at
    ~0.0004 bits/pixel; see the module docstring's bucket-sort rationale).

    Contexts: 0-2 flag maps (per channel), 3.. pixels:
    3 + q * 3 + c (activity-major, mirroring the AC id layout)."""
    hp = -(-height // 8) * 8
    wp = -(-width // 8) * 8
    nbl = (hp // 8) * (wp // 8)
    n_pix = hp * wp
    runs = [(c, nbl) for c in range(3)]
    runs += [(3 + c, n_pix) for c in range(3)]  # nominal q=0 ctx
    spans, dst, step_ctx = _pad_runs(runs, lanes)
    t_a = sum(n_pad for _c, _d, _n, n_pad in spans[:3]) // lanes

    # per-pixel-phase-step static metadata (first-token rule): channel and
    # SORTED block index of the step's first token
    chan_l, blk_l = [], []
    for (c0, _d, n_real, n_pad), c in zip(spans[3:], range(3)):
        for s in range(n_pad // lanes):
            o = min(s * lanes, n_real - 1)
            chan_l.append(c)
            blk_l.append(o // 64)
    return {
        "runs": runs,
        "spans": spans,
        "hp": hp,
        "wp": wp,
        "nbl": nbl,
        "n_tokens": 3 * nbl + 3 * n_pix,
        "n_padded": dst,
        "T": dst // lanes,
        "t_a": t_a,
        "n_ctx": 3 + 3 * LL_Q,
        "step_ctx": step_ctx,
        "ll_step_chan": np.asarray(chan_l, np.int32),
        "ll_step_blk": np.asarray(blk_l, np.int32),
    }


@lru_cache(maxsize=None)
def padded_layout(height: int, width: int, lanes: int):
    """K-padded token layout for the grouped rANS coder.

    Every context run is padded to a multiple of `lanes` with value-0
    tokens (coded like any other symbol — sub-0.5%% size cost), so each
    K-token scan step carries exactly ONE context. Returns:
      n_padded      total padded tokens (= T * lanes)
      T             scan steps
      step_ctx      [T] int32 context id per step
      ctx_padded    [n_padded] int32 per-token context ids
      spans         list of (ctx, dst_start, n_real, n_run_padded) for
                    scattering real values into the padded stream and
                    slicing them back out
    """
    base = token_layout(height, width)
    spans, dst, step_ctx = _pad_runs(base["runs"], lanes)
    out = dict(base)
    out["spans"] = spans
    out["n_padded"] = dst
    out["T"] = dst // lanes
    out["step_ctx"] = step_ctx
    out["ctx_padded"] = np.repeat(step_ctx, lanes)

    # Two-phase split: phase A = static-context sections (maps, CfL, nnz
    # map, DC) = the first 9 spans; phase B = the AC spans. Span bounds are
    # K-padded, so the split lands exactly on a step boundary.
    n_a_spans = 9
    t_a = sum(n_pad for _c, _d, _n, n_pad in spans[:n_a_spans]) // lanes
    out["t_a"] = t_a

    # Per-AC-step STATIC metadata for the data-dependent context:
    #   step_chan [T_b]  channel of the step's first token
    #   step_pos  [T_b]  zigzag position (1..63) of the first token
    #   step_blk  [T_b]  index into the SORTED block order of the first
    #                    token (q_sorted[chan, blk] is the traced bucket)
    # Offsets past a span's real tokens (K-padding tail) clamp to the last
    # real token so padding steps inherit the tail context.
    nb = base["nb"]
    band = ac_band_table()
    chan_l, pos_l, blk_l = [], [], []
    for (nominal, _d, n_real, n_pad), (c, b) in zip(
        spans[n_a_spans:], [(c, b) for c in range(3) for b in range(N_BANDS)]
    ):
        band_positions = np.nonzero(band == b)[0] + 1  # 1-indexed zigzag
        for s in range(n_pad // lanes):
            o = min(s * lanes, n_real - 1)
            chan_l.append(c)
            pos_l.append(int(band_positions[o // nb]))
            blk_l.append(o % nb)
    out["ac_step_chan"] = np.asarray(chan_l, np.int32)
    out["ac_step_pos"] = np.asarray(pos_l, np.int32)
    out["ac_step_blk"] = np.asarray(blk_l, np.int32)
    return out
