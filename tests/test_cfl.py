"""Chroma-from-luma: correlated chroma must get cheaper, roundtrip must hold."""

import numpy as np

from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.decode import decode_bytes
from jxl_jax.codec.encode import encode_image
from jxl_jax.metrics import calculate_psnr
from tests.conftest import make_test_image


def test_cfl_roundtrip_quality():
    img = make_test_image(96, 96, seed=8)
    data = encode_image(img, CodecConfig(distance=1.0, effort=7))
    out = decode_bytes(data)
    assert calculate_psnr(img, out) > 34.0


def test_cfl_helps_luma_correlated_chroma():
    """An image whose R/B channels are scaled copies of G is the CfL best
    case: with per-tile factors the chroma residual coefficients collapse."""
    rng = np.random.default_rng(4)
    g = np.clip(
        0.5 + 0.25 * np.cumsum(rng.normal(0, 0.05, (64, 64)), axis=1), 0.05, 0.95
    )
    rgb = np.stack([g * 0.55, g, g * 0.8], axis=-1)
    img = (rgb * 255).astype(np.uint8)
    data = encode_image(img, CodecConfig(distance=2.0, effort=5))
    out = decode_bytes(data)
    assert calculate_psnr(img, out) > 33.0
    bpp = len(data) * 8 / (64 * 64)
    assert bpp < 3.0, bpp
