import jax.numpy as jnp
import numpy as np
import pytest

from jxl_jax.entropy.rans import (
    RANS_M,
    deserialize_streams,
    quantize_histograms,
    rans_decode,
    rans_encode,
    serialize_streams,
)
from jxl_jax.entropy.tokens import (
    ALPHABET,
    bit_capacity_words,
    detokenize,
    pack_bits,
    token_nbits,
    tokenize,
    unpack_bits,
    zigzag_map,
    zigzag_unmap,
)


def test_quantize_histograms_sums():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 1000, (5, 37))
    counts[1] = 0  # unused context
    counts[2] = 0
    counts[2, 5] = 17  # single-symbol context
    freq, cum = quantize_histograms(counts)
    assert freq.shape == counts.shape
    np.testing.assert_array_equal(freq.sum(axis=1), RANS_M)
    assert freq.max() < RANS_M
    assert np.all(freq[counts > 0] >= 1)
    np.testing.assert_array_equal(cum[:, 0], 0)
    np.testing.assert_array_equal(np.diff(cum[0]), freq[0, :-1])


def _roundtrip(tokens, ctx, n_ctx, alphabet, lanes=8):
    counts = np.zeros((n_ctx, alphabet), dtype=np.int64)
    np.add.at(counts, (ctx, tokens), 1)
    freq, cum = quantize_histograms(counts)
    words, n_words, states = rans_encode(
        jnp.asarray(tokens), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), lanes=lanes
    )
    # through the serialized form, like the real container does
    blob = serialize_streams(np.asarray(words), int(n_words))
    T = max(1, -(-len(tokens) // lanes))
    words2 = deserialize_streams(blob, T * lanes)
    decoded = rans_decode(
        jnp.asarray(words2),
        jnp.asarray(np.asarray(states)),
        jnp.asarray(ctx),
        jnp.asarray(freq),
        jnp.asarray(cum),
        len(tokens),
        lanes=lanes,
    )
    np.testing.assert_array_equal(np.asarray(decoded), tokens)


def test_rans_roundtrip_uniform():
    rng = np.random.default_rng(42)
    n = 10_000
    tokens = rng.integers(0, 37, n).astype(np.int32)
    ctx = rng.integers(0, 4, n).astype(np.int32)
    _roundtrip(tokens, ctx, 4, 37)


def test_rans_roundtrip_skewed():
    rng = np.random.default_rng(3)
    n = 50_000
    tokens = np.minimum(rng.geometric(0.5, n) - 1, 36).astype(np.int32)
    ctx = (np.arange(n) % 12).astype(np.int32)
    _roundtrip(tokens, ctx, 12, 37, lanes=64)


def test_rans_roundtrip_single_symbol():
    # degenerate: all tokens identical (freq capped at M-1)
    tokens = np.zeros(1000, dtype=np.int32)
    ctx = np.zeros(1000, dtype=np.int32)
    _roundtrip(tokens, ctx, 1, 37)


@pytest.mark.slow
def test_rans_roundtrip_tiny_and_odd_sizes():
    rng = np.random.default_rng(9)
    for n in (1, 2, 7, 8, 9, 255, 256, 257):
        tokens = rng.integers(0, 10, n).astype(np.int32)
        ctx = rng.integers(0, 2, n).astype(np.int32)
        _roundtrip(tokens, ctx, 2, 37, lanes=8)


def test_rans_compression_ratio():
    # heavily skewed data must compress well below 8 bits/token
    rng = np.random.default_rng(5)
    n = 100_000
    tokens = np.minimum(rng.geometric(0.7, n) - 1, 36).astype(np.int32)
    ctx = np.zeros(n, dtype=np.int32)
    counts = np.zeros((1, 37), dtype=np.int64)
    np.add.at(counts, (ctx, tokens), 1)
    freq, cum = quantize_histograms(counts)
    words, n_words, states = rans_encode(
        jnp.asarray(tokens), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), lanes=64
    )
    n_bytes = int(n_words) * 2 + 64 * 4  # words + states
    bits_per_token = n_bytes * 8 / n
    # entropy of geometric(0.7) is ~1.4 bits
    assert bits_per_token < 1.8, bits_per_token


def test_tokenize_roundtrip():
    vals = np.concatenate(
        [np.arange(0, 40), [100, 1000, 65535, 1 << 20, (1 << 24) + 12345]]
    ).astype(np.uint32)
    tok, nbits, mant = tokenize(jnp.asarray(vals))
    assert int(jnp.max(tok)) < ALPHABET
    back = detokenize(tok, mant)
    np.testing.assert_array_equal(np.asarray(back), vals)
    np.testing.assert_array_equal(np.asarray(token_nbits(tok)), np.asarray(nbits))


def test_zigzag_map_roundtrip():
    v = jnp.asarray(np.arange(-1000, 1000, dtype=np.int32))
    u = zigzag_map(v)
    assert int(jnp.min(u)) >= 0
    np.testing.assert_array_equal(np.asarray(zigzag_unmap(u)), np.asarray(v))


def test_pack_unpack_bytes():
    from jxl_jax.entropy.tokens import byte_capacity, pack_bytes, unpack_bytes

    rng = np.random.default_rng(21)
    n = 5000
    vals = rng.integers(0, 1 << 24, n).astype(np.uint32)
    tok, nbits, mant = tokenize(jnp.asarray(vals))
    arr, total = pack_bytes(nbits, mant, byte_capacity(n))
    nbytes = np.asarray((np.asarray(nbits) + 7) // 8)
    assert int(total) == int(nbytes.sum())
    mant2 = unpack_bytes(nbits, arr)
    np.testing.assert_array_equal(np.asarray(mant2), np.asarray(mant))
    back = detokenize(tok, mant2)
    np.testing.assert_array_equal(np.asarray(back), vals)


def test_pack_unpack_bits():
    rng = np.random.default_rng(11)
    n = 5000
    vals = rng.integers(0, 1 << 20, n).astype(np.uint32)
    tok, nbits, mant = tokenize(jnp.asarray(vals))
    cap = bit_capacity_words(n)
    words, total_bits = pack_bits(nbits, mant, cap)
    assert int(total_bits) == int(jnp.sum(nbits))
    mant2 = unpack_bits(nbits, words)
    np.testing.assert_array_equal(np.asarray(mant2), np.asarray(mant))


@pytest.mark.parametrize("lanes", [8, 32, 256])
def test_rans_lane_counts(lanes):
    rng = np.random.default_rng(13)
    n = 4097
    tokens = rng.integers(0, 20, n).astype(np.int32)
    ctx = np.zeros(n, dtype=np.int32)
    _roundtrip(tokens, ctx, 1, 37, lanes=lanes)
