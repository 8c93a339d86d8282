"""Vectorized interleaved rANS entropy coder (on device).

The reference relies on libjxl's C++ ANS coder (inside `cjxl`, invoked at
`docker_manager.rs:100-136`) — an inherently sequential per-stream loop. The
design here runs K independent rANS streams in lockstep as one
vectorized `lax.scan`: symbol i is coded by lane (i % K), so every scan step
advances K coder states with pure vector ops plus small table gathers.
SURVEY §7 "hard parts #1" calls for exactly this many-parallel-streams
design; bitstream *assembly* (ragged per-lane concatenation) is host-side
numpy, per-symbol modeling is all on device.

Scheme: 32-bit states, 16-bit renormalization words, 12-bit frequency
precision. Single-conditional renorm is exact for these parameters
(2^32 >> 16 = 2^16 < f << 20 for all f >= 1).

Encode walks symbols in reverse (scan with reverse=True); the word emitted
while encoding symbol i is exactly the word the decoder consumes when
decoding symbol i. Words are stored in GLOBAL CONSUMPTION ORDER (row-major
over (step, lane) where a renorm fires): the decoder then reads a
contiguous window per step — a dynamic_slice plus a tiny lane-local rank
gather — instead of a per-lane pointer gather over the whole stream, and no
per-lane length table is needed in the container (only the lane count and
final states).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

RANS_PRECISION = 12  # frequency bits; M = 4096
RANS_M = 1 << RANS_PRECISION
RANS_L = np.uint32(1 << 16)  # state lower bound
DEFAULT_LANES = 256


def quantize_histograms(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize per-context symbol counts to frequencies summing to 2^12.

    counts: [C, A] nonnegative ints. Returns (freq [C, A], cum [C, A]) uint32.
    Every symbol with a nonzero count gets freq >= 1; the max freq is capped
    at M-1 so that `f << 20` never overflows uint32 in the encoder.
    Deterministic (runs on host; tables are stored in the bitstream header,
    so encoder and decoder always agree).
    """
    counts = np.asarray(counts, dtype=np.int64)
    C, A = counts.shape
    freq = np.zeros((C, A), dtype=np.int64)
    for c in range(C):
        row = counts[c]
        total = row.sum()
        if total == 0:
            # Unused context: put all mass on symbol 0 (capped).
            freq[c, 0] = RANS_M - 1
            freq[c, 1 if A > 1 else 0] += 1
            continue
        f = np.floor(row * (RANS_M / total)).astype(np.int64)
        f[(row > 0) & (f == 0)] = 1
        diff = RANS_M - f.sum()
        # Adjust the largest bucket; it is always big enough to absorb diff.
        f[np.argmax(f)] += diff
        if f.max() >= RANS_M:  # single-symbol context
            j = int(np.argmax(f))
            f[j] = RANS_M - 1
            f[(j + 1) % A] += 1
        assert f.sum() == RANS_M and f.max() < RANS_M and f.min() >= 0
        freq[c] = f
    cum = np.concatenate([np.zeros((C, 1), dtype=np.int64), np.cumsum(freq, axis=1)[:, :-1]], axis=1)
    return freq.astype(np.uint32), cum.astype(np.uint32)


def quantize_histograms_t(counts: jnp.ndarray):
    """On-device histogram quantization (traced twin of quantize_histograms).

    Lets the whole encoder run as ONE jit call — no host round-trip between
    token statistics and rANS coding. The quantized tables are what get stored in the header, so
    the two implementations don't need to produce identical tables — only
    valid ones (sum 2^12, max < 2^12, nonzero counts kept >= 1).
    counts: [C, A] int32 -> (freq, cum) uint32.
    """
    c = counts.astype(jnp.int32)
    a = c.shape[1]
    total = jnp.sum(c, axis=1, keepdims=True)
    # unused contexts: put all mass on symbol 0
    c = c.at[:, 0].add(jnp.where(total[:, 0] == 0, 1, 0))
    total = jnp.maximum(total, 1)
    # f32 ratio avoids c*M overflowing int32 on multi-megapixel images
    # (counts can exceed 2^19); table exactness doesn't matter, validity does.
    f = jnp.floor((c.astype(jnp.float32) / total.astype(jnp.float32)) * RANS_M).astype(
        jnp.int32
    )
    f = jnp.where((c > 0) & (f == 0), 1, f)
    diff = RANS_M - jnp.sum(f, axis=1)  # >= -(A-1), argmax bucket absorbs it
    am = jnp.argmax(f, axis=1)
    onehot_am = am[:, None] == jnp.arange(a)[None, :]
    f = f + jnp.where(onehot_am, diff[:, None], 0)
    # cap single-symbol contexts at M-1 (encoder overflow guard)
    over = (jnp.max(f, axis=1) >= RANS_M)[:, None]
    onehot_next = ((am + 1) % a)[:, None] == jnp.arange(a)[None, :]
    f = f - jnp.where(onehot_am & over, 1, 0) + jnp.where(onehot_next & over, 1, 0)
    f = f.astype(jnp.uint32)
    cum = jnp.concatenate(
        [jnp.zeros((f.shape[0], 1), jnp.uint32), jnp.cumsum(f, axis=1)[:, :-1]],
        axis=1,
    )
    return f, cum


def _lane_layout(n: int, lanes: int) -> int:
    """Number of scan steps for n symbols over `lanes` streams."""
    return max(1, -(-n // lanes))


def rans_encode(tokens, ctx_ids, freq, cum, lanes: int = DEFAULT_LANES):
    """Encode tokens[N] (int32, < alphabet) with contexts ctx_ids[N].

    freq/cum: [C, A] uint32 quantized tables (from quantize_histograms).
    Returns (words_flat [T * lanes] uint16 in consumption order,
             n_words int32 scalar,
             states [lanes] uint32 final states).
    jit-compatible for fixed N.
    """
    n = tokens.shape[0]
    T = _lane_layout(n, lanes)
    pad = T * lanes - n

    tok = jnp.concatenate([tokens.astype(jnp.int32), jnp.zeros(pad, jnp.int32)])
    ctx = jnp.concatenate([ctx_ids.astype(jnp.int32), jnp.zeros(pad, jnp.int32)])
    valid = (jnp.arange(T * lanes) < n).reshape(T, lanes)

    # single fused gather: freq in the low half-word, cum in the high
    # (both < 4096). Flat 1D indexing: one 1-D gather instead of the
    # multi-dim gather XLA lowers 2D advanced indexing to.
    combo_tab = (freq.astype(jnp.uint32) | (cum.astype(jnp.uint32) << 16)).reshape(-1)
    a = freq.shape[1]
    combo = combo_tab[ctx * a + tok].reshape(T, lanes)
    f_all = combo & jnp.uint32(0xFFFF)
    c_all = combo >> 16

    def step(states, inp):
        f, c, v = inp
        x = states
        emit = jnp.logical_and(v, x >= (f << 20))
        word = x & jnp.uint32(0xFFFF)
        x = jnp.where(emit, x >> 16, x)
        x_enc = ((x // f) << RANS_PRECISION) + (x % f) + c
        # Invalid (padding) positions never emit and leave the state unchanged.
        x = jnp.where(v, x_enc, states)
        return x, (word, emit)

    init = jnp.full((lanes,), RANS_L, dtype=jnp.uint32)
    # unroll: the body is a handful of vector ops and per-iteration loop
    # overhead dominates, so several bodies per iteration are a large win.
    states, (words, emits) = jax.lax.scan(
        step, init, (f_all, c_all, valid), reverse=True, unroll=8
    )

    # Compact emissions into global consumption order: target position =
    # (words consumed before this row) + (rank of this lane among the row's
    # emitters). Both are cumsums; the scatter indices are unique.
    e32 = emits.astype(jnp.int32)
    rank_in_row = jnp.cumsum(e32, axis=1) - e32  # exclusive, per row
    row_counts = jnp.sum(e32, axis=1)  # [T]
    row_offsets = jnp.cumsum(row_counts) - row_counts  # exclusive, per row
    n_words = row_offsets[-1] + row_counts[-1]
    flat_target = jnp.where(emits, row_offsets[:, None] + rank_in_row, T * lanes)
    out = jnp.zeros((T * lanes,), jnp.uint32).at[flat_target.reshape(-1)].set(
        words.reshape(-1), mode="drop", unique_indices=True
    )
    return out.astype(jnp.uint16), n_words.astype(jnp.int32), states


def build_decode_table(freq, cum):
    """[C, M] fused slot -> (symbol, freq, cum-bias) lookup.

    One uint32 entry per slot — sym in bits 0..5, freq in 6..17, bias in
    18..29 — so the per-step symbol resolution is a SINGLE gather of `lanes`
    elements from the table instead of a [lanes, A] compare-reduce.
    """
    C, A = freq.shape
    assert A <= 64, "fused table packs the symbol id into 6 bits"
    cum_i32 = cum.astype(jnp.int32)
    slots = jnp.arange(RANS_M, dtype=jnp.int32)
    # sym[c, slot] = (number of cum entries <= slot) - 1
    sym = (
        jnp.sum(slots[None, :, None] >= cum_i32[:, None, :], axis=-1) - 1
    ).astype(jnp.int32)
    f_tab = jnp.take_along_axis(freq.astype(jnp.uint32), sym, axis=1)
    bias = jnp.take_along_axis(cum.astype(jnp.uint32), sym, axis=1)
    return sym.astype(jnp.uint32) | (f_tab << 6) | (bias << 18)


def rans_decode(words_flat, states, ctx_ids, freq, cum, n: int, lanes: int = DEFAULT_LANES):
    """Decode n tokens. words_flat: [>= T*lanes + lanes] uint16/uint32 in
    consumption order, states: [lanes] uint32 (final encoder states),
    ctx_ids: [N] int32. Returns tokens [n] int32.

    Per step the lanes that renormalize read the next `popcount(need)` words
    of the stream in lane order: a contiguous dynamic_slice window plus a
    lane-local rank gather — no stream-wide pointer gather.
    """
    T = _lane_layout(n, lanes)
    pad = T * lanes - n
    ctx = jnp.concatenate([ctx_ids.astype(jnp.int32), jnp.zeros(pad, jnp.int32)])
    ctx_all = ctx.reshape(T, lanes)
    valid = (jnp.arange(T * lanes) < n).reshape(T, lanes)

    words_u32 = jnp.concatenate(
        [words_flat.astype(jnp.uint32), jnp.zeros((lanes,), jnp.uint32)]
    )
    combo_flat = build_decode_table(freq, cum).reshape(-1)  # [C*M]

    def step(carry, inp):
        x, gptr = carry
        c_ids, v = inp
        slot = (x & jnp.uint32(RANS_M - 1)).astype(jnp.int32)
        combo = combo_flat[c_ids * RANS_M + slot]
        s = (combo & jnp.uint32(0x3F)).astype(jnp.int32)
        f = (combo >> 6) & jnp.uint32(0xFFF)
        cm = combo >> 18
        x_dec = f * (x >> RANS_PRECISION) + slot.astype(jnp.uint32) - cm
        need = jnp.logical_and(v, x_dec < RANS_L)
        need32 = need.astype(jnp.int32)
        rank = jnp.cumsum(need32) - need32  # exclusive rank among needers
        window = jax.lax.dynamic_slice(words_u32, (gptr,), (lanes,))
        w = jnp.take_along_axis(window, rank, axis=0)
        x_new = jnp.where(need, (x_dec << 16) | w, x_dec)
        x_new = jnp.where(v, x_new, x)
        return (x_new, gptr + jnp.sum(need32)), jnp.where(v, s, 0)

    init = (states.astype(jnp.uint32), jnp.int32(0))
    _, syms = jax.lax.scan(step, init, (ctx_all, valid))
    return syms.reshape(-1)[:n].astype(jnp.int32)


def serialize_streams(words_flat: np.ndarray, n_words: int) -> bytes:
    """Trim the consumption-order word array to its used prefix (the stream
    IS the serialization — no ragged reassembly needed anymore)."""
    return np.asarray(words_flat)[: int(n_words)].astype("<u2").tobytes()


def deserialize_streams(data: bytes, cap_words: int) -> np.ndarray:
    """Stream bytes -> padded uint16 array of static length cap_words."""
    flat = np.frombuffer(data, dtype="<u2")
    out = np.zeros(cap_words, dtype=np.uint16)
    out[: flat.shape[0]] = flat
    return out
