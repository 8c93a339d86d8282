"""Cross-implementation conformance: the native C++ coder and the JAX coder
must produce bit-identical streams and decode each other's output — the
"bitstream exactness" validation SURVEY §7 hard-part #2 calls for (the
reference has no such cross-check; its codec and harness trust libjxl)."""

import jax.numpy as jnp
import numpy as np
import pytest

from jxl_jax.entropy.rans import (
    deserialize_streams,
    quantize_histograms,
    rans_decode,
    rans_encode,
    serialize_streams,
)

native = pytest.importorskip("jxl_jax.native")

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _data(n=20000, seed=0, n_ctx=5):
    rng = np.random.default_rng(seed)
    tokens = np.minimum(rng.geometric(0.4, n) - 1, 36).astype(np.int32)
    ctx = rng.integers(0, n_ctx, n).astype(np.int32)
    counts = np.zeros((n_ctx, 37), np.int64)
    np.add.at(counts, (ctx, tokens), 1)
    freq, cum = quantize_histograms(counts)
    return tokens, ctx, freq, cum


def test_native_encode_matches_jax():
    tokens, ctx, freq, cum = _data()
    lanes = 16
    wj, nj, sj = rans_encode(
        jnp.asarray(tokens), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), lanes=lanes
    )
    wn, nn, sn = native.rans_encode_native(tokens, ctx, freq, cum, lanes)
    assert int(nj) == nn
    np.testing.assert_array_equal(np.asarray(sj), sn)
    np.testing.assert_array_equal(np.asarray(wj)[: int(nj)], wn[:nn])
    # serialized bytes identical too
    assert serialize_streams(np.asarray(wj), int(nj)) == serialize_streams(wn, nn)


def test_native_decodes_jax_stream():
    tokens, ctx, freq, cum = _data(seed=1)
    lanes = 8
    wj, nj, sj = rans_encode(
        jnp.asarray(tokens), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), lanes=lanes
    )
    out = native.rans_decode_native(
        np.asarray(wj), int(nj), np.asarray(sj), ctx, freq, cum, len(tokens), lanes
    )
    np.testing.assert_array_equal(out, tokens)


def test_jax_decodes_native_stream():
    tokens, ctx, freq, cum = _data(seed=2)
    lanes = 8
    wn, nn, sn = native.rans_encode_native(tokens, ctx, freq, cum, lanes)
    blob = serialize_streams(wn, nn)
    T = max(1, -(-len(tokens) // lanes))
    words2 = deserialize_streams(blob, T * lanes)
    decoded = rans_decode(
        jnp.asarray(words2), jnp.asarray(sn), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), len(tokens), lanes=lanes
    )
    np.testing.assert_array_equal(np.asarray(decoded), tokens)


def test_native_bitpack_matches_jax():
    from jxl_jax.entropy.tokens import bit_capacity_words, pack_bits, tokenize, unpack_bits

    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << 18, 5000).astype(np.uint32)
    tok, nbits, mant = tokenize(jnp.asarray(vals))
    cap = bit_capacity_words(5000)
    wj, _ = pack_bits(nbits, mant, cap)
    wn = native.pack_bits_native(np.asarray(nbits), np.asarray(mant), cap)
    np.testing.assert_array_equal(np.asarray(wj), wn)
    mj = unpack_bits(nbits, jnp.asarray(wn))
    mn = native.unpack_bits_native(np.asarray(nbits), wn)
    np.testing.assert_array_equal(np.asarray(mj), np.asarray(mant))
    np.testing.assert_array_equal(mn, np.asarray(mant))
