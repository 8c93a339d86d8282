"""Lossless palette/index mode."""

import numpy as np

from jxl_jax.codec import decode, encode
from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.container import read_container

from tests.conftest import make_test_image


def glyph_image(h=96, w=128, seed=5):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 245, np.uint8)
    for _ in range(10):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 15)
        img[y : y + 9, x : x + 14] = [10, 10, 60]
    img[h // 2 : h // 2 + 8, :] = [200, 30, 30]
    return img


def test_palette_detection():
    img = glyph_image()
    pal, idx = encode._palette_of(img)
    assert len(pal) == 3
    assert pal.shape[1] == 3
    # luma-sorted ascending
    luma = 0.299 * pal[:, 0] + 0.587 * pal[:, 1] + 0.114 * pal[:, 2]
    assert (np.diff(luma.astype(float)) >= 0).all()
    # index map inverts exactly
    assert np.array_equal(pal[idx], img)
    # photographic content has no palette
    assert encode._palette_of(make_test_image(64, 96)) is None


def test_palette_roundtrip_bit_exact():
    img = glyph_image()
    data = encode.encode_image(img, CodecConfig(distance=0.0))
    s = read_container(data)
    assert s.header.lossless
    assert len(s.acs_extra) == 9  # 3 colors x 3 bytes: palette mode won
    out = np.asarray(decode.decode_bytes(data))
    assert np.array_equal(out, img)


def test_palette_beats_plain_on_glyphs():
    img = glyph_image(seed=6)
    pal_fin = encode._palette_async(
        encode._palette_of(img)[1], encode._palette_of(img)[0],
        CodecConfig(distance=0.0),
    )
    plain_fin = encode._modular_async(img, CodecConfig(distance=0.0))
    assert len(pal_fin()) < len(plain_fin())


def test_palette_rejected_when_plain_wins():
    """A smooth 256-level gradient has <= 256 colors but the YCoCg
    gradient predictor beats index coding — the measured-bytes decision
    must keep the plain arm."""
    g = np.tile(np.arange(256, dtype=np.uint8), (32, 1))
    img = np.stack([g, g, g], axis=-1)
    data = encode.encode_image(img, CodecConfig(distance=0.0))
    s = read_container(data)
    assert len(s.acs_extra) == 0
    assert np.array_equal(np.asarray(decode.decode_bytes(data)), img)


def test_palette_256_colors_roundtrip():
    """Full 256-entry palette still round-trips exactly when it wins."""
    rng = np.random.default_rng(8)
    pal = rng.integers(0, 255, (256, 3), dtype=np.uint8)
    idx = rng.integers(0, 256, (64, 96))
    # big flat region so palette coding wins over YCoCg
    idx[:48, :] = 7
    img = pal[idx]
    data = encode.encode_image(img, CodecConfig(distance=0.0))
    out = np.asarray(decode.decode_bytes(data))
    assert np.array_equal(out, img)
