"""Grouped-stream rANS coder (container v5): the codec's entropy layer.

Replaces the single global consumption-order stream (v4) with per-GROUP
streams, where a group is 128 adjacent rANS lanes (the unit one decode
program owns). Combined with `codec.layout.padded_layout` (one static
context per K-token scan step) this gives the decoder a form with NO
per-token table gathers and NO cross-group coupling:

- symbol resolution: per step, ONE (freq, cum) table row is active; the
  row is streamed, and the symbol is the count of cum entries <= slot.
- word consumption: group g's words are stored in that group's own
  consumption order, so a step reads the words of its renormalizing
  lanes at the group's stream pointer plus their intra-group rank.
- mantissa bytes: same per-group consumption-order layout, consumed the
  same way (up to 3 bytes per token, byte-aligned).

The encoder is plain XLA (its scan carries only lane states, with no
data-dependent memory access); `decode_grouped` is the XLA reference
decoder — the bit-exact twin of the GPU kernel in entropy/triton_rans.py
— and the decoder on the CPU.

Replaces the role of libjxl's C++ ANS coder in the reference
(`cjxl` internals, invoked at `docker_manager.rs:100-136`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jxl_jax.entropy.rans import RANS_L, RANS_M, RANS_PRECISION

GROUP = 128  # lanes per group: a container parameter (per-group streams)
MAX_NBYTES = 3
# Tail slack each per-group stream buffer carries past its used words /
# mantissa bytes: a decode step reads up to GROUP words and MAX_NBYTES *
# GROUP bytes beyond the group's pointer.
WORD_SLACK = GROUP
MANT_SLACK = MAX_NBYTES * GROUP


def n_groups(lanes: int) -> int:
    assert lanes % GROUP == 0, "lane count must be a multiple of 128"
    return lanes // GROUP


def context_rows(step_ctx, freq, cum):
    """Per-step (freq, cum) table rows via a one-hot matmul.

    step_ctx: [T] int32; freq/cum: [C, A] uint32 (< 4096 = 12-bit ints).
    Precision.HIGHEST is REQUIRED for exactness: at default precision the
    GPU may run f32 matmuls in TF32 (11 significant bits), which rounds
    values above 2048; HIGHEST keeps full f32, exact for 12-bit integers.
    Returns rows_f, rows_c as [T, A] int32.
    """
    c = freq.shape[0]
    oh = (step_ctx[:, None] == jnp.arange(c)[None, :]).astype(jnp.float32)
    rows_f = jnp.dot(
        oh,
        freq.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    rows_c = jnp.dot(
        oh,
        cum.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return rows_f.astype(jnp.int32), rows_c.astype(jnp.int32)


def kernel_rows(step_ctx, freq, cum):
    """[T, 128] i32 row stream for the decoders: lanes 0..63 hold the
    freq row, lanes 64..127 the cum row; slots beyond the alphabet read as
    freq 0 / cum M so binary search never lands there."""
    T = step_ctx.shape[0]
    a = freq.shape[1]
    rows_f, rows_c = context_rows(step_ctx, freq, cum)
    f64 = jnp.zeros((T, 64), jnp.int32)
    c64 = jnp.full((T, 64), RANS_M, jnp.int32)
    f64 = jax.lax.dynamic_update_slice(f64, rows_f, (0, 0))
    c64 = jax.lax.dynamic_update_slice(c64, rows_c, (0, 0))
    return jnp.concatenate([f64, c64], axis=1)


def _group_order_targets(fire, lanes: int):
    """Per-element target positions in the grouped consumption-order
    stream. fire: [T, K] bool (element emits/consumes a unit).

    Returns (tgt [T, K] int32 with group-LOCAL offsets, counts [G] int32).
    Global position = group_base[g] + tgt.
    """
    T = fire.shape[0]
    G = lanes // GROUP
    e = fire.astype(jnp.int32).reshape(T, G, GROUP)
    rank = jnp.cumsum(e, axis=2) - e  # exclusive, within (step, group)
    row_tot = jnp.sum(e, axis=2)  # [T, G]
    row_off = jnp.cumsum(row_tot, axis=0) - row_tot  # exclusive over steps
    counts = row_off[-1] + row_tot[-1]  # [G]
    tgt = (row_off[:, :, None] + rank).reshape(T, lanes)
    return tgt, counts


# Step-chunk size for the encoder's one-hot (f, c) precompute: the [Tc, K, A]
# f32 one-hot materializes as the einsum operand, so chunking bounds it to
# ~0.4 GB (8192 steps x 256 lanes x 52 syms x 4 B x 2) — without it a
# 4096x4096 image's 51M-token stream would need >10 GB at once. Streams with
# T <= ENC_CHUNK_T (every common image size) compile to the identical
# single-scan program as before.
ENC_CHUNK_T = 8192


def rans_encode_grouped(tokens, step_ctx, freq, cum, lanes: int):
    """Encode a PADDED token stream (length T*lanes, every position real).

    tokens: [T*K] int32; step_ctx: [T] int32 (single context per step).
    Returns (words [T*K] uint16 — concatenated per-group segments in group
    order, counts [G] int32 words per group, states [K] uint32).
    """
    n = tokens.shape[0]
    T = n // lanes
    a = freq.shape[1]
    tok = tokens.reshape(T, lanes)

    # (f, c) per token: one-hot select against the step's streamed row —
    # one matmul instead of a per-token table gather.
    rows_f, rows_c = context_rows(step_ctx, freq, cum)

    def step(states, inp):
        f, c = inp
        x = states
        emit = x >= (f << 20)
        word = x & jnp.uint32(0xFFFF)
        x = jnp.where(emit, x >> 16, x)
        x = ((x // f) << RANS_PRECISION) + (x % f) + c
        return x, (word, emit)

    def chunk(states, tok_c, rf, rc):
        oh = (tok_c[:, :, None] == jnp.arange(a)[None, None, :]).astype(jnp.float32)
        f_all = jnp.einsum(
            "tka,ta->tk",
            oh,
            rf.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.uint32)
        c_all = jnp.einsum(
            "tka,ta->tk",
            oh,
            rc.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.uint32)
        return jax.lax.scan(step, states, (f_all, c_all), reverse=True, unroll=8)

    init = jnp.full((lanes,), RANS_L, dtype=jnp.uint32)
    starts = list(range(0, T, ENC_CHUNK_T))
    # named scopes: profiler traces attribute device time to these stages
    # (tools/route_ab.py reads them)
    with jax.named_scope("rans_encode_scan"):
        if len(starts) == 1:
            states, (words, emits) = chunk(init, tok, rows_f, rows_c)
        else:
            # rANS encodes back-to-front (reverse scan): the LAST chunk
            # runs first from the initial states, and the carry threads
            # backwards. Outputs stay in forward order; concatenation
            # reassembles them.
            states = init
            parts: dict = {}
            for s in reversed(starts):
                e = min(s + ENC_CHUNK_T, T)
                states, parts[s] = chunk(states, tok[s:e], rows_f[s:e], rows_c[s:e])
            words = jnp.concatenate([parts[s][0] for s in starts])
            emits = jnp.concatenate([parts[s][1] for s in starts])

    with jax.named_scope("rans_word_scatter"):
        tgt, counts = _group_order_targets(emits, lanes)
        base = jnp.cumsum(counts) - counts  # [G] group segment bases
        g_ids = jnp.arange(lanes) // GROUP
        flat_tgt = jnp.where(emits, base[g_ids][None, :] + tgt, T * lanes)
        out = jnp.zeros((T * lanes,), jnp.uint32).at[flat_tgt.reshape(-1)].set(
            words.reshape(-1), mode="drop", unique_indices=True
        )
    return out.astype(jnp.uint16), counts, states


def _pack_mantissa_direct(nbytes, m, lanes: int, cap_bytes: int):
    """Reference path: 3 full-stream masked scatters (one per byte lane)."""
    T = nbytes.shape[0] // lanes
    nb = nbytes.reshape(T, lanes)
    G = lanes // GROUP
    e = nb.reshape(T, G, GROUP)
    rank = jnp.cumsum(e, axis=2) - e
    row_tot = jnp.sum(e, axis=2)
    row_off = jnp.cumsum(row_tot, axis=0) - row_tot
    counts = row_off[-1] + row_tot[-1]
    base = jnp.cumsum(counts) - counts
    g_ids = jnp.arange(lanes) // GROUP
    off = (row_off[:, :, None] + rank).reshape(T, lanes) + base[g_ids][None, :]

    m2 = m.reshape(T, lanes)
    out = jnp.zeros((cap_bytes,), jnp.uint32)
    for j in range(MAX_NBYTES):
        sel = j < nb
        idx = jnp.where(sel, off + j, cap_bytes)
        byte = (m2 >> jnp.uint32(8 * j)) & jnp.uint32(0xFF)
        out = out.at[idx.reshape(-1)].set(
            byte.reshape(-1), mode="drop", unique_indices=True
        )
    return out, counts


def pack_mantissa_grouped(nbits, mant, lanes: int, cap_bytes: int):
    """Mantissa bytes in per-group consumption order.

    nbits/mant: [T*K] (padded stream order). Returns (bytes_arr [cap_bytes]
    uint32 holding one byte each — concatenated per-group segments,
    counts [G] int32 bytes per group).

    Fast path: only a few %% of tokens carry a mantissa at normal
    distances, but a masked scatter pays per SOURCE element. So: ONE
    full-stream scatter compacts the bearing tokens per group (mant|nbytes
    packed in a single u32), and the three byte passes then run at the
    compacted size. If a
    group overflows the compaction bucket (very low distance), lax.cond
    falls back to the direct 3-pass path.
    """
    n = nbits.shape[0]
    T = n // lanes
    G = lanes // GROUP
    nbytes = (nbits.astype(jnp.int32) + 7) // 8
    m = mant.astype(jnp.uint32)

    capc = max(1024, (n // G) // 4)  # per-group compaction bucket (25%)
    e = nbytes.reshape(T, G, GROUP)
    bearing = (e > 0).astype(jnp.int32)
    brank = jnp.cumsum(bearing, axis=2) - bearing  # within (step, group)
    brow_tot = jnp.sum(bearing, axis=2)
    brow_off = jnp.cumsum(brow_tot, axis=0) - brow_tot
    bcount = brow_off[-1] + brow_tot[-1]  # [G] bearing tokens per group
    tgt_in_g = brow_off[:, :, None] + brank  # [T, G, GROUP]
    g_col = jnp.arange(G)[None, :, None]
    tgt = jnp.where(
        bearing > 0, g_col * capc + tgt_in_g, G * capc
    ).reshape(-1)
    payload = (m | (nbytes.astype(jnp.uint32) << 24)).reshape(-1)
    comp = jnp.zeros((G * capc,), jnp.uint32).at[tgt].set(
        payload, mode="drop", unique_indices=True
    ).reshape(G, capc)

    def fast(_):
        nb_c = (comp >> 24).astype(jnp.int32)  # [G, capc]
        m_c = comp & jnp.uint32(0xFFFFFF)
        off_c = jnp.cumsum(nb_c, axis=1) - nb_c
        counts = off_c[:, -1] + nb_c[:, -1]
        base = jnp.cumsum(counts) - counts
        out = jnp.zeros((cap_bytes,), jnp.uint32)
        for j in range(MAX_NBYTES):
            sel = j < nb_c
            idx = jnp.where(sel, base[:, None] + off_c + j, cap_bytes)
            byte = (m_c >> jnp.uint32(8 * j)) & jnp.uint32(0xFF)
            out = out.at[idx.reshape(-1)].set(
                byte.reshape(-1), mode="drop", unique_indices=True
            )
        return out, counts

    def slow(_):
        return _pack_mantissa_direct(nbytes, m, lanes, cap_bytes)

    return jax.lax.cond(jnp.max(bcount) <= capc, fast, slow, operand=None)


@partial(jax.jit, static_argnames=("T", "lanes", "return_carry"))
def decode_grouped(
    words_g, mant_g, states, rows, *, T: int, lanes: int,
    gptr0=None, bptr0=None, return_carry: bool = False,
):
    """XLA reference decoder — bit-exact twin of the GPU kernel.

    words_g: [G, capw] uint32 (one u16 word per element, group segments,
      >= 128 slack elements); mant_g: [G, capm] uint32 (one byte per
      element, >= 384 slack); states: [K] uint32; rows: [T, 128] i32 from
      kernel_rows. Returns values [T*K] uint32 (detokenized, pre-zigzag).

    Two-phase use (container v8): gptr0/bptr0 [G] i32 resume the word and
    mantissa stream pointers from a previous phase; return_carry=True also
    returns (final_states [K] u32, final_gptr [G], final_bptr [G]).
    """
    G = lanes // GROUP
    x0 = states.astype(jnp.uint32).reshape(G, GROUP)
    rows_f = rows[:, :64]
    rows_c = rows[:, 64:]

    def step(carry, inp):
        x, gptr, bptr = carry  # [G, 128] u32, [G] i32, [G] i32
        f_row, c_row = inp  # [64] i32 each
        slot = (x & jnp.uint32(RANS_M - 1)).astype(jnp.int32)
        ge = slot[:, :, None] >= c_row[None, None, :]  # [G, 128, 64]
        sym = jnp.sum(ge.astype(jnp.int32), axis=-1) - 1
        oh = ge & ~jnp.concatenate(
            [ge[..., 1:], jnp.zeros_like(ge[..., :1])], axis=-1
        )
        f = jnp.sum(jnp.where(oh, f_row[None, None, :], 0), axis=-1)
        bias = jnp.sum(jnp.where(oh, c_row[None, None, :], 0), axis=-1)
        x_dec = f.astype(jnp.uint32) * (x >> RANS_PRECISION) + (
            slot - bias
        ).astype(jnp.uint32)
        need = x_dec < RANS_L
        need32 = need.astype(jnp.int32)
        rank = jnp.cumsum(need32, axis=1) - need32
        wins = jnp.stack(
            [
                jax.lax.dynamic_slice(words_g[g], (gptr[g],), (GROUP,))
                for g in range(G)
            ]
        )
        w = jnp.take_along_axis(wins, rank, axis=1)
        x_new = jnp.where(need, (x_dec << 16) | w, x_dec)

        # mantissa consumption
        nbits = jnp.where(sym >= 32, sym - 27, 0)
        nbyt = (nbits + 7) >> 3
        brank = jnp.cumsum(nbyt, axis=1) - nbyt
        mwins = jnp.stack(
            [
                jax.lax.dynamic_slice(mant_g[g], (bptr[g],), (3 * GROUP,))
                for g in range(G)
            ]
        )
        mval = jnp.zeros_like(x, jnp.uint32)
        for j in range(MAX_NBYTES):
            idx = jnp.clip(brank + j, 0, 3 * GROUP - 1)
            b = jnp.take_along_axis(mwins, idx, axis=1)
            mval = mval | jnp.where(j < nbyt, b << jnp.uint32(8 * j), 0).astype(
                jnp.uint32
            )
        exp = jnp.where(sym >= 32, sym - 27, 0).astype(jnp.uint32)
        value = jnp.where(
            sym >= 32, (jnp.uint32(1) << exp) + mval, sym.astype(jnp.uint32)
        )
        carry = (
            x_new,
            gptr + jnp.sum(need32, axis=1),
            bptr + jnp.sum(nbyt, axis=1),
        )
        return carry, value

    init = (
        x0,
        jnp.zeros((G,), jnp.int32) if gptr0 is None else gptr0.astype(jnp.int32),
        jnp.zeros((G,), jnp.int32) if bptr0 is None else bptr0.astype(jnp.int32),
    )
    carry, vals = jax.lax.scan(step, init, (rows_f, rows_c))
    out = vals.reshape(T * lanes)
    if return_carry:
        xf, gf, bf = carry
        return out, xf.reshape(lanes), gf, bf
    return out
