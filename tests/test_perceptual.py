"""Perceptual metric properties: anchors, orientation, monotonicity.

The reference treats Butteraugli/SSIMULACRA2 as black boxes (parses tool
stdout, `metrics.rs:96-144`); these tests pin the on-device
implementations to the properties comparisons rely on.
"""

import numpy as np

from bench import synth_kodak
from jxl_jax.metrics.perceptual import calculate_butteraugli, calculate_ssimulacra2


def _blur(img, s):
    from scipy import ndimage

    return np.clip(
        ndimage.gaussian_filter(img.astype(np.float64), (s, s, 0)), 0, 255
    ).astype(np.uint8)


def test_identical_images_are_perfect():
    img = synth_kodak(96, 128)
    d, p3 = calculate_butteraugli(img, img)
    assert d == 0.0 and p3 == 0.0
    assert calculate_ssimulacra2(img, img) == 100.0


def test_monotone_under_noise():
    img = synth_kodak(96, 128)
    rng = np.random.default_rng(0)
    prev_ba, prev_s2 = 0.0, 100.0
    for n in (2, 6, 18):
        comp = np.clip(
            img.astype(np.float64) + rng.normal(0, n, img.shape), 0, 255
        ).astype(np.uint8)
        ba, _ = calculate_butteraugli(img, comp)
        s2 = calculate_ssimulacra2(img, comp)
        assert ba > prev_ba
        assert s2 < prev_s2
        prev_ba, prev_s2 = ba, s2


def test_monotone_under_blur():
    img = synth_kodak(96, 128)
    prev_ba, prev_s2 = 0.0, 100.0
    for s in (0.6, 1.5, 3.0):
        comp = _blur(img, s)
        ba, _ = calculate_butteraugli(img, comp)
        s2 = calculate_ssimulacra2(img, comp)
        assert ba > prev_ba
        assert s2 < prev_s2
        prev_ba, prev_s2 = ba, s2


def test_ssimulacra2_feature_shape():
    import jax.numpy as jnp

    from jxl_jax.metrics.perceptual import _S2_SCALES, _ssimulacra2_features

    img = synth_kodak(96, 128)
    f = np.asarray(_ssimulacra2_features(jnp.asarray(img), jnp.asarray(img)))
    # the SSIMULACRA2 feature family: scales x channels x components x norms
    assert f.shape == (_S2_SCALES, 3, 3, 2)
    # identical -> ssim==1 up to float cancellation noise in the variance maps
    assert np.allclose(f[:, :, 0, :], 0.0, atol=5e-3)
