"""Grouped-stream rANS coder (container v5): property + differential tests.

The XLA decoder (entropy/grouped.py:decode_grouped) is the bit-exact
reference for the GPU kernel (entropy/triton_rans.py); on CPU these tests
pin the encoder/XLA-decoder pair plus the kernel in interpreter mode on
small cases (interpretation is slow, so the big cases cover XLA only;
tests/test_triton_kernel.py holds the kernel-vs-twin carry checks).
"""

import numpy as np
import pytest
import jax.numpy as jnp
from jxl_jax.entropy.grouped import (
    GROUP,
    MANT_SLACK,
    WORD_SLACK,
    decode_grouped,
    kernel_rows,
    pack_mantissa_grouped,
    rans_encode_grouped,
)
from jxl_jax.entropy.triton_rans import decode_grouped_triton
from jxl_jax.entropy.rans import quantize_histograms
from jxl_jax.entropy.tokens import tokenize


def _roundtrip(vals, lanes, T, step_ctx, use_pallas=False):
    N = T * lanes
    C = int(step_ctx.max()) + 1
    token, nbits, mant = map(np.asarray, tokenize(jnp.asarray(vals)))
    ctx_tok = np.repeat(step_ctx, lanes)
    counts = np.zeros((C, 52), np.int64)
    np.add.at(counts, (ctx_tok, token), 1)
    freq, cum = quantize_histograms(counts)
    fj, cj = jnp.asarray(freq), jnp.asarray(cum)
    words, wcounts, states = map(
        np.asarray,
        rans_encode_grouped(
            jnp.asarray(token.astype(np.int32)),
            jnp.asarray(step_ctx.astype(np.int32)),
            fj,
            cj,
            lanes,
        ),
    )
    mbytes, mcounts = map(
        np.asarray,
        pack_mantissa_grouped(jnp.asarray(nbits), jnp.asarray(mant), lanes, N * 3),
    )
    G = lanes // GROUP
    capw = int(wcounts.max()) + WORD_SLACK
    capm = int(mcounts.max()) + MANT_SLACK
    wg = np.zeros((G, capw), np.uint32)
    mg = np.zeros((G, capm), np.uint32)
    wb = np.concatenate([[0], np.cumsum(wcounts)])
    mb = np.concatenate([[0], np.cumsum(mcounts)])
    for g in range(G):
        wg[g, : wcounts[g]] = words[wb[g] : wb[g + 1]]
        mg[g, : mcounts[g]] = mbytes[mb[g] : mb[g + 1]]
    rows = kernel_rows(jnp.asarray(step_ctx.astype(np.int32)), fj, cj)
    if use_pallas:
        out = decode_grouped_triton(
            jnp.asarray(wg),
            jnp.asarray(mg),
            jnp.asarray(states).reshape(G, GROUP),
            rows[:, None],
            T=T,
            lanes=lanes,
            interpret=True,
        )[0][0]
    else:
        out = decode_grouped(
            jnp.asarray(wg), jnp.asarray(mg), jnp.asarray(states), rows, T=T, lanes=lanes
        )
    return np.asarray(out)


def test_grouped_roundtrip_small_tokens():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 16, size=16 * 128).astype(np.uint32)
    out = _roundtrip(vals, 128, 16, np.repeat(np.arange(4), 4))
    assert np.array_equal(out, vals)


def test_grouped_roundtrip_mantissas_multibyte():
    rng = np.random.default_rng(1)
    vals = rng.geometric(0.1, size=24 * 256).astype(np.uint32) - 1
    vals[rng.random(vals.size) < 0.02] += 1 << 17  # force 3-byte mantissas
    out = _roundtrip(vals, 256, 24, np.repeat(np.arange(6), 4))
    assert np.array_equal(out, vals)


def test_grouped_roundtrip_wide_lanes():
    rng = np.random.default_rng(2)
    vals = rng.geometric(0.4, size=8 * 1024).astype(np.uint32) - 1
    out = _roundtrip(vals, 1024, 8, np.zeros(8, np.int64))
    assert np.array_equal(out, vals)


def test_pallas_kernel_interpret_matches():
    rng = np.random.default_rng(3)
    vals = rng.geometric(0.2, size=8 * 128).astype(np.uint32) - 1
    vals[rng.random(vals.size) < 0.05] += 500
    out = _roundtrip(vals, 128, 8, np.zeros(8, np.int64), use_pallas=True)
    assert np.array_equal(out, vals)


def test_word_counts_cover_stream():
    rng = np.random.default_rng(4)
    vals = rng.geometric(0.3, size=8 * 256).astype(np.uint32) - 1
    token, _nb, _mt = map(np.asarray, tokenize(jnp.asarray(vals)))
    counts = np.zeros((1, 52), np.int64)
    np.add.at(counts, (np.zeros(vals.size, np.int64), token), 1)
    freq, cum = quantize_histograms(counts)
    words, wcounts, _states = map(
        np.asarray,
        rans_encode_grouped(
            jnp.asarray(token.astype(np.int32)),
            jnp.asarray(np.zeros(8, np.int32)),
            jnp.asarray(freq),
            jnp.asarray(cum),
            256,
        ),
    )
    total = int(wcounts.sum())
    assert total <= words.shape[0]
    assert np.all(words[total:] == 0)  # only the used prefix is populated


def test_encode_chunked_matches_single():
    """The step-chunked encoder (ENC_CHUNK_T, used for gigapixel streams)
    must produce the identical words/counts/states as one unchunked scan."""
    import jxl_jax.entropy.grouped as gr

    rng = np.random.default_rng(7)
    lanes, T = 128, 48
    vals = rng.integers(0, 200, size=T * lanes).astype(np.uint32)
    step_ctx = np.asarray((np.arange(T) // 16) % 3, np.int32)
    token, _, _ = map(np.asarray, tokenize(jnp.asarray(vals)))
    counts = np.zeros((3, 52), np.int64)
    np.add.at(counts, (np.repeat(step_ctx, lanes), token), 1)
    freq, cum = quantize_histograms(counts)
    args = (jnp.asarray(token), jnp.asarray(step_ctx), jnp.asarray(freq), jnp.asarray(cum), lanes)

    ref = [np.asarray(x) for x in rans_encode_grouped(*args)]
    old = gr.ENC_CHUNK_T
    try:
        gr.ENC_CHUNK_T = 16  # force 3 chunks
        got = [np.asarray(x) for x in rans_encode_grouped(*args)]
    finally:
        gr.ENC_CHUNK_T = old
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)


def test_histogram_chunked_matches_single():
    import jxl_jax.codec.encode as enc

    rng = np.random.default_rng(3)
    token = jnp.asarray(rng.integers(0, 52, size=5000).astype(np.int32))
    ctx = rng.integers(0, 24, size=5000).astype(np.int32)
    ref = np.asarray(enc._histogram_mxu(token, ctx, 24))
    old = enc.HIST_CHUNK
    try:
        enc.HIST_CHUNK = 700  # force 8 chunks
        got = np.asarray(enc._histogram_mxu(token, ctx, 24))
    finally:
        enc.HIST_CHUNK = old
    np.testing.assert_array_equal(ref, got)


def test_pallas_kernel_batched_matches():
    """The batched kernel (B same-geometry streams in one launch, one
    program per 128-lane group of every stream) must decode each stream
    bit-identically to the XLA reference — the decode.grid path relies on
    it."""
    lanes, T, B = 256, 6, 3
    step_ctx = np.repeat(np.arange(3), 2)
    streams = []
    for b in range(B):
        rng = np.random.default_rng(10 + b)
        vals = rng.geometric(0.15 + 0.1 * b, size=T * lanes).astype(np.uint32) - 1
        vals[rng.random(vals.size) < 0.04] += 300 + 100 * b
        streams.append(vals)

    G = lanes // GROUP
    enc = []
    for vals in streams:
        token, nbits, mant = map(np.asarray, tokenize(jnp.asarray(vals)))
        ctx_tok = np.repeat(step_ctx, lanes)
        counts = np.zeros((3, 52), np.int64)
        np.add.at(counts, (ctx_tok, token), 1)
        freq, cum = quantize_histograms(counts)
        fj, cj = jnp.asarray(freq), jnp.asarray(cum)
        words, wcounts, states = map(
            np.asarray,
            rans_encode_grouped(
                jnp.asarray(token.astype(np.int32)),
                jnp.asarray(step_ctx.astype(np.int32)),
                fj, cj, lanes,
            ),
        )
        mbytes, mcounts = map(
            np.asarray,
            pack_mantissa_grouped(
                jnp.asarray(nbits), jnp.asarray(mant), lanes, T * lanes * 3
            ),
        )
        rows = kernel_rows(jnp.asarray(step_ctx.astype(np.int32)), fj, cj)
        enc.append((words, wcounts, states, mbytes, mcounts, rows))

    capw = max(int(e[1].max()) for e in enc) + WORD_SLACK
    capm = max(int(e[4].max()) for e in enc) + MANT_SLACK
    wg = np.zeros((B * G, capw), np.uint32)
    mg = np.zeros((B * G, capm), np.uint32)
    for b, (words, wcounts, _st, mbytes, mcounts, _r) in enumerate(enc):
        wb = np.concatenate([[0], np.cumsum(wcounts)])
        mb = np.concatenate([[0], np.cumsum(mcounts)])
        for g in range(G):
            wg[b * G + g, : wcounts[g]] = words[wb[g] : wb[g + 1]]
            mg[b * G + g, : mcounts[g]] = mbytes[mb[g] : mb[g + 1]]
    states_b = jnp.asarray(np.stack([e[2] for e in enc])).reshape(B * G, GROUP)
    rows_b = jnp.stack([e[5] for e in enc], axis=1)  # [T, B, 128]

    out, _st, _ptr = decode_grouped_triton(
        jnp.asarray(wg), jnp.asarray(mg), states_b, rows_b,
        T=T, lanes=lanes, interpret=True,
    )
    out = np.asarray(out)
    for b, vals in enumerate(streams):
        assert np.array_equal(out[b], vals), f"stream {b} mismatch"
