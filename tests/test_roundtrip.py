"""End-to-end codec tests: encode -> container bytes -> decode.

The reference had no codec round-trip tests at all (its codec was external;
SURVEY §4 lists this as a gap to fix). These are the M1 gate: decode must
exactly invert the entropy layer, and quantization error must land in the
expected PSNR range per distance.
"""

import numpy as np
import pytest

from jxl_jax.codec.config import CodecConfig, Strategy
from jxl_jax.codec.container import read_container, read_container_header
from jxl_jax.codec.decode import decode_bytes
from jxl_jax.codec.encode import encode_image
from jxl_jax.metrics import calculate_psnr
from tests.conftest import make_test_image


def test_roundtrip_d1_psnr():
    img = make_test_image(128, 160)
    cfg = CodecConfig(distance=1.0, effort=3)
    data = encode_image(img, cfg, orig_name="synth.png")
    out = decode_bytes(data)
    assert out.shape == img.shape and out.dtype == np.uint8
    psnr = calculate_psnr(img, out)
    bpp = len(data) * 8 / (128 * 160)
    assert psnr > 36.0, (psnr, bpp)
    assert bpp < 6.0, bpp


@pytest.mark.slow
def test_distance_rate_quality_tradeoff():
    img = make_test_image(128, 128, seed=3)
    sizes, psnrs = [], []
    for d in (0.5, 2.0, 8.0):
        data = encode_image(img, CodecConfig(distance=d, effort=3))
        sizes.append(len(data))
        psnrs.append(calculate_psnr(img, decode_bytes(data)))
    assert sizes[0] > sizes[1] > sizes[2]
    assert psnrs[0] > psnrs[1] > psnrs[2]


def test_header_metadata():
    img = make_test_image(64, 72)
    cfg = CodecConfig(distance=3.0, effort=5, strategy=Strategy.COMBINED)
    data = encode_image(img, cfg, orig_name="meta.png")
    hdr = read_container_header(data)
    assert (hdr.height, hdr.width) == (64, 72)
    assert hdr.distance == pytest.approx(3.0)
    assert hdr.effort == 5
    assert hdr.strategy_name == "COMBINED"
    assert hdr.orig_name == "meta.png"


def test_container_roundtrip_fields():
    img = make_test_image(40, 56, seed=9)
    data = encode_image(img, CodecConfig(distance=1.0, effort=3))
    s = read_container(data)
    assert s.freq.sum(axis=1).max() == 1 << 12
    assert len(s.stream_words) % 2 == 0 and len(s.stream_words) > 0
    assert s.states.shape[0] == s.header.lanes
    out = decode_bytes(data)
    assert out.shape == img.shape


@pytest.mark.slow
def test_nonmultiple_of_8_sizes():
    for h, w in [(17, 23), (8, 8), (9, 8), (100, 33)]:
        img = make_test_image(h, w, seed=h * 100 + w)
        data = encode_image(img, CodecConfig(distance=2.0, effort=3))
        out = decode_bytes(data)
        assert out.shape == (h, w, 3)
        assert calculate_psnr(img, out) > 25.0


def test_flat_image_compresses_tiny():
    img = np.full((128, 128, 3), 130, np.uint8)
    data = encode_image(img, CodecConfig(distance=1.0, effort=3))
    bpp = len(data) * 8 / (128 * 128)
    assert bpp < 0.6, bpp  # header-dominated at this size (lane state + tables)
    out = decode_bytes(data)
    assert calculate_psnr(img, out) > 45.0
