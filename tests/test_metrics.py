import numpy as np

from jxl_jax.metrics import (
    calculate_ms_ssim,
    calculate_mse,
    calculate_psnr,
    calculate_ssim,
    file_size_ratio,
)
from tests.conftest import make_test_image


def test_file_size_ratio_grid():
    # mirror of the reference's only real unit test (metrics_tests.rs:21-56)
    for a in range(5):
        for b in range(5):
            got = file_size_ratio(a, b)
            if b == 0:
                assert got == 0.0
            else:
                assert got == a / b


def test_mse_identical_is_zero():
    img = make_test_image(64, 64)
    assert calculate_mse(img, img) == 0.0
    assert calculate_psnr(img, img) == float("inf")
    assert abs(calculate_ssim(img, img) - 1.0) < 1e-5
    assert abs(calculate_ms_ssim(img, img) - 1.0) < 1e-4


def test_mse_known_value():
    a = np.zeros((16, 16, 3), np.uint8)
    b = np.full((16, 16, 3), 10, np.uint8)
    assert abs(calculate_mse(a, b) - 100.0) < 1e-5
    assert abs(calculate_psnr(a, b) - 10 * np.log10(255**2 / 100)) < 1e-4


def test_metrics_order_with_noise():
    # more noise -> worse on every metric
    img = make_test_image(96, 96).astype(np.int32)
    rng = np.random.default_rng(0)
    small = np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)
    big = np.clip(img + rng.integers(-25, 26, img.shape), 0, 255).astype(np.uint8)
    img = img.astype(np.uint8)
    assert calculate_mse(img, small) < calculate_mse(img, big)
    assert calculate_psnr(img, small) > calculate_psnr(img, big)
    assert calculate_ssim(img, small) > calculate_ssim(img, big)
    assert calculate_ms_ssim(img, small) > calculate_ms_ssim(img, big)


def test_perceptual_metrics_order():
    from jxl_jax.metrics import calculate_butteraugli, calculate_ssimulacra2

    img = make_test_image(96, 96).astype(np.int32)
    rng = np.random.default_rng(0)
    small = np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)
    big = np.clip(img + rng.integers(-25, 26, img.shape), 0, 255).astype(np.uint8)
    img = img.astype(np.uint8)
    d_small, p_small = calculate_butteraugli(img, small)
    d_big, p_big = calculate_butteraugli(img, big)
    assert d_small < d_big
    assert p_small < p_big
    d0, p0 = calculate_butteraugli(img, img)
    assert d0 == 0.0 and p0 == 0.0
    s_small = calculate_ssimulacra2(img, small)
    s_big = calculate_ssimulacra2(img, big)
    s_perfect = calculate_ssimulacra2(img, img)
    assert s_big < s_small < s_perfect
    assert abs(s_perfect - 100.0) < 1.0
