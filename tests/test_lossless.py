"""Lossless (d=0) modular mode: exact integer round trips.

The reference's legacy sweep grid includes distance 0.0 = cjxl lossless
(`old_test_jxl.py:16-27`); these tests pin the on-device equivalent
(codec/lossless.py) to BIT-EXACT reconstruction.
"""

import numpy as np
import jax.numpy as jnp

from bench import synth_kodak
from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.decode import decode_bytes
from jxl_jax.codec.encode import encode_image
from jxl_jax.codec.container import read_container
from jxl_jax.codec.lossless import (
    grad_reconstruct,
    grad_residual,
    ycocg_forward,
    ycocg_inverse,
)


def test_ycocg_roundtrip_all_extremes():
    rng = np.random.default_rng(0)
    samples = np.concatenate(
        [
            rng.integers(0, 256, (1000, 3)),
            np.array([[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255]]),
        ]
    ).astype(np.uint8)
    rgb = samples.reshape(1, -1, 3)
    back = np.asarray(ycocg_inverse(ycocg_forward(jnp.asarray(rgb))))
    assert np.array_equal(back, rgb)


def test_gradient_inverse_is_prefix_sum():
    rng = np.random.default_rng(1)
    planes = jnp.asarray(rng.integers(-500, 500, (3, 17, 29)).astype(np.int32))
    back = grad_reconstruct(grad_residual(planes))
    assert np.array_equal(np.asarray(back), np.asarray(planes))


def test_lossless_roundtrip_photo_like():
    img = synth_kodak(96, 160)
    data = encode_image(img, CodecConfig(distance=0.0))
    out = decode_bytes(data)
    assert np.array_equal(out, img)
    hdr = read_container(data).header
    assert hdr.lossless and hdr.distance == 0.0


def test_lossless_roundtrip_noise_and_flat():
    rng = np.random.default_rng(2)
    noise = rng.integers(0, 256, (64, 128, 3)).astype(np.uint8)
    assert np.array_equal(decode_bytes(encode_image(noise, CodecConfig(distance=0.0))), noise)
    flat = np.full((40, 136, 3), 77, np.uint8)
    blob = encode_image(flat, CodecConfig(distance=0.0))
    assert np.array_equal(decode_bytes(blob), flat)
    # flat image must compress far below raw size
    assert len(blob) < flat.size // 10


def test_lossless_beats_raw_on_photo():
    img = synth_kodak(128, 192)
    data = encode_image(img, CodecConfig(distance=0.0))
    assert len(data) < img.size  # < 24 bpp
