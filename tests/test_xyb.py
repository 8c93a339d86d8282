import jax.numpy as jnp
import numpy as np

from jxl_jax.core.xyb import (
    linear_rgb_to_xyb,
    linear_to_srgb,
    srgb_to_linear,
    srgb_to_xyb,
    xyb_to_linear_rgb,
    xyb_to_srgb,
)


def test_srgb_transfer_roundtrip():
    v = jnp.linspace(0, 1, 257)
    back = linear_to_srgb(srgb_to_linear(v))
    np.testing.assert_allclose(np.asarray(back), np.asarray(v), atol=1e-5)


def test_xyb_roundtrip():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    xyb = linear_rgb_to_xyb(jnp.asarray(rgb))
    back = xyb_to_linear_rgb(xyb)
    np.testing.assert_allclose(np.asarray(back), rgb, atol=2e-5)


def test_srgb_xyb_roundtrip_u8_exact():
    # every 8-bit gray value must round-trip exactly through XYB
    vals = np.arange(256, dtype=np.float32) / 255.0
    rgb = np.stack([vals, vals, vals], axis=-1)[None]
    back = np.asarray(xyb_to_srgb(srgb_to_xyb(jnp.asarray(rgb))))
    assert np.max(np.abs(back - rgb)) < 0.5 / 255.0


def test_y_is_luminance_like():
    # Y must increase with gray level; X near zero for neutral colors
    grays = np.linspace(0.05, 0.95, 10).astype(np.float32)
    rgb = np.stack([grays, grays, grays], axis=-1)
    xyb = np.asarray(srgb_to_xyb(jnp.asarray(rgb)))
    assert np.all(np.diff(xyb[:, 1]) > 0)
    assert np.max(np.abs(xyb[:, 0])) < 1e-3
