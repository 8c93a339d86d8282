"""Hybrid-uint tokenization and vectorized byte-aligned mantissa storage.

JPEG XL codes integers as a small token (entropy-coded) plus raw mantissa
bits; the reference gets this from libjxl's C++ coder. Here:

- token(v) = v for v < 32, else 27 + floor(log2 v), with
  nbits = token - 27 mantissa bits (v = 2^nbits + mantissa).
- signed values are mapped to unsigned via the zigzag map 2v / -2v-1 first.
- mantissas are stored BYTE-aligned (little-endian, ceil(nbits/8) bytes):
  byte granularity costs ~3.5 padding bits on the rare (split=32) tokens
  that carry a mantissa, and in exchange the whole pack/unpack is at most
  MAX_NBYTES=3 masked scatter/gather passes instead of a per-bit loop —
  each pass touches every element, so pass count is the metric that
  matters.

Decode order is two-pass and fully parallel: rANS first yields all tokens,
token -> byte count gives every mantissa's offset by cumsum, then <=3
vectorized gathers reconstruct the values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TOKEN_SPLIT = 32  # values below this are their own token
MAX_NBITS = 24  # supports values up to 2^25 - 1
MAX_NBYTES = 3
ALPHABET = TOKEN_SPLIT + (MAX_NBITS - 5) + 1  # tokens 0..51 -> 52 symbols


def zigzag_map(v):
    """Signed int32 -> unsigned: 0,-1,1,-2,2.. -> 0,1,2,3,4.."""
    v = v.astype(jnp.int32)
    return jnp.where(v >= 0, 2 * v, -2 * v - 1).astype(jnp.uint32)


def zigzag_unmap(u):
    u = u.astype(jnp.int32)
    return jnp.where(u % 2 == 0, u // 2, -(u // 2) - 1)


def tokenize(values):
    """uint32 values -> (token int32, nbits int32, mantissa uint32)."""
    v = values.astype(jnp.uint32)
    nbits_total = 32 - jax.lax.clz(v).astype(jnp.int32)  # bit length; 0 for v == 0
    big = v >= TOKEN_SPLIT
    exp = jnp.where(big, nbits_total - 1, 0).astype(jnp.int32)
    token = jnp.where(big, 27 + exp, v.astype(jnp.int32))
    nbits = jnp.where(big, exp, 0).astype(jnp.int32)
    mantissa = jnp.where(big, v - (jnp.uint32(1) << exp.astype(jnp.uint32)), 0).astype(jnp.uint32)
    return token, nbits, mantissa


def detokenize(token, mantissa):
    """(token, mantissa) -> uint32 values."""
    token = token.astype(jnp.int32)
    big = token >= TOKEN_SPLIT
    exp = jnp.where(big, token - 27, 0).astype(jnp.uint32)
    return jnp.where(big, (jnp.uint32(1) << exp) + mantissa.astype(jnp.uint32), token.astype(jnp.uint32))


def token_nbits(token):
    """Mantissa bit count implied by a token (decoder side)."""
    token = token.astype(jnp.int32)
    return jnp.where(token >= TOKEN_SPLIT, token - 27, 0)


def nbits_to_nbytes(nbits):
    return (nbits.astype(jnp.int32) + 7) // 8


def pack_bytes(nbits, mantissa, cap_bytes: int):
    """Pack mantissas into a byte stream (values 0..255 held in uint32 lanes).

    Little-endian within each mantissa. Returns (bytes_arr [cap_bytes]
    uint32, total_bytes int32). At most MAX_NBYTES masked scatters.
    """
    nbytes = nbits_to_nbytes(nbits)
    offsets = jnp.cumsum(nbytes) - nbytes
    total = jnp.sum(nbytes)
    out = jnp.zeros((cap_bytes,), jnp.uint32)
    m = mantissa.astype(jnp.uint32)
    for j in range(MAX_NBYTES):
        mask = j < nbytes
        idx = jnp.where(mask, offsets + j, cap_bytes)
        byte = (m >> jnp.uint32(8 * j)) & jnp.uint32(0xFF)
        out = out.at[idx].set(byte, mode="drop", unique_indices=True)
    return out, total


def unpack_bytes(nbits, bytes_arr):
    """Inverse of pack_bytes: per-symbol mantissas from the byte stream."""
    nbytes = nbits_to_nbytes(nbits)
    offsets = jnp.cumsum(nbytes) - nbytes
    n_arr = bytes_arr.shape[0]
    out = jnp.zeros(nbits.shape, jnp.uint32)
    for j in range(MAX_NBYTES):
        mask = j < nbytes
        idx = jnp.where(mask, offsets + j, 0).clip(0, n_arr - 1)
        byte = bytes_arr[idx] & jnp.uint32(0xFF)
        out = out | jnp.where(mask, byte << jnp.uint32(8 * j), 0).astype(jnp.uint32)
    # mask to the declared bit count (robustness against corrupt streams)
    return out & ((jnp.uint32(1) << nbits.astype(jnp.uint32)) - jnp.uint32(1))


def byte_capacity(n_symbols: int) -> int:
    """Static byte budget for n symbols' mantissas."""
    return max(4, n_symbols * MAX_NBYTES)


# --- legacy bit-exact packers (kept for the native-core conformance tests) --


def pack_bits(nbits, mantissa, total_words: int):
    """MSB-first bit packing into uint32 words (per-bit loop; slow on device —
    superseded by pack_bytes in the codec, retained for cross-validation
    against the native C++ implementation)."""
    nbits = nbits.astype(jnp.int32)
    offsets = jnp.cumsum(nbits) - nbits
    total_bits = jnp.sum(nbits)
    acc = jnp.zeros((total_words,), jnp.uint32)
    for b in range(MAX_NBITS):
        mask = b < nbits
        bitpos = offsets + b
        word_idx = jnp.where(mask, bitpos // 32, total_words)
        bit_in_word = (bitpos % 32).astype(jnp.uint32)
        bit = (mantissa >> (nbits - 1 - b).clip(0).astype(jnp.uint32)) & jnp.uint32(1)
        contrib = jnp.where(mask, bit << (jnp.uint32(31) - bit_in_word), 0).astype(jnp.uint32)
        acc = acc.at[word_idx].add(contrib, mode="drop")
    return acc, total_bits


def unpack_bits(nbits, words):
    """Inverse of pack_bits."""
    nbits = nbits.astype(jnp.int32)
    offsets = jnp.cumsum(nbits) - nbits
    out = jnp.zeros(nbits.shape, jnp.uint32)
    for b in range(MAX_NBITS):
        mask = b < nbits
        bitpos = offsets + b
        word_idx = jnp.where(mask, bitpos // 32, 0)
        bit_in_word = (bitpos % 32).astype(jnp.uint32)
        w = words[word_idx]
        bit = (w >> (jnp.uint32(31) - bit_in_word)) & jnp.uint32(1)
        out = out | jnp.where(mask, bit << (nbits - 1 - b).clip(0).astype(jnp.uint32), 0).astype(jnp.uint32)
    return out


def bit_capacity_words(n_symbols: int) -> int:
    """Static uint32 word budget for n symbols' mantissas (legacy packer)."""
    return max(1, (n_symbols * MAX_NBITS + 31) // 32)
