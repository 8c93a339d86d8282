"""Decoder robustness against malformed containers.

The reference's harness skip-on-failure contract assumes codec failures
are CLEAN errors (`benchmark.rs:661-677`); libjxl's decoder is hardened.
This suite pins the same property for JXT: random truncations, random
byte flips, and adversarial header fields must either decode (bit flips
in entropy payload are legal streams — garbage pixels are fine) or raise
ValueError. Never a hang, never an unbounded allocation, never a crash.
"""

import struct

import numpy as np
import pytest

from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.container import MAGIC, read_container, read_container_header
from jxl_jax.codec.decode import decode_bytes
from jxl_jax.codec.encode import encode_image

from tests.conftest import make_test_image


@pytest.fixture(scope="module")
def small_container():
    rgb = make_test_image(48, 64, seed=3)
    return rgb, encode_image(rgb, CodecConfig(distance=2.0, effort=3))


@pytest.fixture(scope="module")
def small_lossless_container():
    rgb = make_test_image(48, 64, seed=4)
    return rgb, encode_image(rgb, CodecConfig(distance=0.0))


def test_truncations_raise_cleanly(small_container):
    _, data = small_container
    r = np.random.default_rng(11)
    cuts = sorted(set(int(x) for x in r.integers(0, len(data), 60)))
    for cut in cuts + [0, 1, 4, 8, len(data) - 1]:
        with pytest.raises(ValueError):
            read_container(data[:cut])


def test_byte_flips_never_crash(small_container):
    rgb, data = small_container
    h, w = rgb.shape[:2]
    r = np.random.default_rng(12)
    flips = 0
    for _ in range(60):
        pos = int(r.integers(0, len(data)))
        bit = int(r.integers(0, 8))
        mut = bytearray(data)
        mut[pos] ^= 1 << bit
        mut = bytes(mut)
        try:
            out = decode_bytes(mut)
        except ValueError:
            continue  # clean rejection is a pass
        # decoded: must still be a sane image of the signaled geometry
        assert out.dtype == np.uint8
        assert out.shape[2] == 3
        flips += 1
    assert flips > 0  # payload flips should mostly still decode


def test_lossless_byte_flips_never_crash(small_lossless_container):
    _, data = small_lossless_container
    r = np.random.default_rng(13)
    for _ in range(25):
        pos = int(r.integers(0, len(data)))
        mut = bytearray(data)
        mut[pos] ^= 1 << int(r.integers(0, 8))
        try:
            out = decode_bytes(bytes(mut))
            assert out.dtype == np.uint8
        except ValueError:
            pass


def _patch_header(data: bytes, **fields) -> bytes:
    """Rewrite fixed header fields of a valid container."""
    version, height, width, distance, effort, strategy, flags, name_len = (
        struct.unpack_from("<BIIfBBBH", data, 4)
    )
    vals = dict(
        version=version, height=height, width=width, distance=distance,
        effort=effort, strategy=strategy, flags=flags, name_len=name_len,
    )
    vals.update(fields)
    head = struct.pack(
        "<BIIfBBBH",
        vals["version"], vals["height"], vals["width"], vals["distance"],
        vals["effort"], vals["strategy"], vals["flags"], vals["name_len"],
    )
    return data[:4] + head + data[4 + len(head):]


def _patch_stream_fields(data: bytes, **fields) -> bytes:
    """Rewrite the lanes/n_tokens/n_ctx/alphabet quad after the name."""
    (name_len,) = struct.unpack_from("<H", data, 4 + struct.calcsize("<BIIfBBB"))
    off = 4 + struct.calcsize("<BIIfBBBH") + name_len
    lanes, n_tokens, n_ctx, alphabet = struct.unpack_from("<HIHB", data, off)
    vals = dict(lanes=lanes, n_tokens=n_tokens, n_ctx=n_ctx, alphabet=alphabet)
    vals.update(fields)
    quad = struct.pack(
        "<HIHB", vals["lanes"], vals["n_tokens"], vals["n_ctx"], vals["alphabet"]
    )
    return data[:off] + quad + data[off + len(quad):]


def test_adversarial_header_fields(small_container):
    _, data = small_container
    # huge / zero dims
    for h, w in [(0, 64), (1 << 21, 64), (1 << 14, 1 << 14), (48, 0)]:
        with pytest.raises(ValueError):
            read_container(_patch_header(data, height=h, width=w))
    # geometry-inconsistent token/context counts
    for kw in [
        dict(n_tokens=0),
        dict(n_tokens=0xFFFFFFFF),
        dict(n_ctx=1),
        dict(n_ctx=0xFFFF),
        dict(alphabet=255),
        dict(lanes=0),
        dict(lanes=130),
        dict(lanes=0xFF80),
    ]:
        with pytest.raises(ValueError):
            read_container(_patch_stream_fields(data, **kw))
    # name overrunning the whole buffer
    with pytest.raises(ValueError):
        read_container(_patch_header(data, name_len=0xFFFF))
    # old version fails fast
    with pytest.raises(ValueError):
        read_container(_patch_header(data, version=7))
    # flipping the modular bit makes n_tokens/n_ctx inconsistent
    version_flags = struct.unpack_from("<BIIfBBBH", data, 4)
    with pytest.raises(ValueError):
        read_container(_patch_header(data, flags=version_flags[6] ^ 2))


def test_bad_magic_and_empty():
    for blob in [b"", b"JX", b"NOPE" + b"\0" * 64, MAGIC]:
        with pytest.raises(ValueError):
            read_container(blob)
    with pytest.raises(ValueError):
        read_container_header(b"JXT1\x08")


def test_forged_stream_counts(small_container):
    """Word/mantissa counts inconsistent with section lengths reject
    cleanly instead of driving huge pow2 upload buckets."""
    _, data = small_container
    s = read_container(data)  # sanity: valid parses
    # find the n_stream_words field: it sits right after states+counts
    # sections; easiest robust approach — flip wcounts via re-serialize
    from jxl_jax.codec.container import write_container

    s.wcounts = s.wcounts.copy()
    s.wcounts[0] += 7  # sum no longer matches payload length
    forged = write_container(s)
    # write_container re-derives n_stream_words from the payload, so the
    # forged counts disagree with the section length marker
    with pytest.raises(ValueError):
        read_container(forged)


def test_striped_wrapper_truncations():
    """JXTS wrapper parsing rejects malformed input cleanly too."""
    from jxl_jax.codec.tiled import read_striped, write_striped

    wrapped = write_striped(16, 32, [b"sec0" * 10, b"sec1" * 20])
    r = np.random.default_rng(14)
    for cut in sorted(set(int(x) for x in r.integers(0, len(wrapped), 30))):
        with pytest.raises(ValueError):
            read_striped(wrapped[:cut])
    # forged section count / huge dims
    import struct as _s

    huge = bytearray(wrapped)
    _s.pack_into("<H", huge, 6, 0xFFFF)
    with pytest.raises(ValueError):
        read_striped(bytes(huge))
    bad_dims = bytearray(wrapped)
    _s.pack_into("<I", bad_dims, 8, 1 << 24)
    with pytest.raises(ValueError):
        read_striped(bytes(bad_dims))
