"""Quality metrics in pure jnp — parity with `benchmark-jpegxl/src/metrics.rs`.

The reference shells out for everything: MSE/PSNR as Rust pixel loops
(`image_reader.rs:555-606` — a per-pixel scalar loop, SURVEY §3.2 "HOT LOOP
#2"), SSIM via host ImageMagick `magick compare -metric SSIM`
(`metrics.rs:64-84`), MS-SSIM stubbed to 0.0 (`benchmark.rs:933,958`).
Here they are all vectorized jnp (VPU) and jit-able; MS-SSIM is actually
implemented instead of stubbed.

Conventions match the reference: metrics are computed over RGB u8 pixel
values (0..255), PSNR uses max=255 (`image_reader.rs:604-606`), and
`file_size_ratio` returns 0.0 on a zero denominator (`metrics.rs:15-26`,
exercised by `tests/metrics_tests.rs:21-56`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def file_size_ratio(a: float, b: float) -> float:
    """Size ratio a/b with the reference's 0-denominator convention."""
    if b == 0:
        return 0.0
    return float(a) / float(b)


@jax.jit
def _mse(a, b):
    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    return jnp.mean(d * d)


def calculate_mse(orig: np.ndarray, comp: np.ndarray) -> float:
    """Mean squared error over u8 RGB pixels (all channels pooled)."""
    return float(_mse(jnp.asarray(orig), jnp.asarray(comp)))


def psnr_from_mse(mse: float, max_value: float = 255.0) -> float:
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(max_value * max_value / mse))


def calculate_psnr(orig: np.ndarray, comp: np.ndarray, max_value: float = 255.0) -> float:
    return psnr_from_mse(calculate_mse(orig, comp), max_value)


def _gaussian_kernel(radius: int = 5, sigma: float = 1.5) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _filter2d_sep(img, kernel):
    """Separable 2D filter over the leading two axes of [H, W, C].

    precision=HIGHEST: at default precision the GPU may run f32 convs in
    TF32, whose rounding corrupts the variance cancellations in SSIM.
    """
    pad = kernel.shape[0] // 2
    # reflect-pad then valid conv via depthwise approach using lax.conv
    img_p = jnp.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="symmetric")
    # vertical
    v = jax.lax.conv_general_dilated(
        img_p.transpose(2, 0, 1)[:, None],  # [C, 1, H, W]
        kernel[None, None, :, None],
        (1, 1),
        "VALID",
        precision=jax.lax.Precision.HIGHEST,
    )
    h = jax.lax.conv_general_dilated(
        v,
        kernel[None, None, None, :],
        (1, 1),
        "VALID",
        precision=jax.lax.Precision.HIGHEST,
    )
    return h[:, 0].transpose(1, 2, 0)


@partial(jax.jit, static_argnames=("max_value",))
def _ssim_map(a, b, max_value: float = 255.0):
    """SSIM (Wang et al.) with 11x11 gaussian sigma=1.5 window, per channel."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    k = _gaussian_kernel(5, 1.5)
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    mu_a = _filter2d_sep(a, k)
    mu_b = _filter2d_sep(b, k)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = _filter2d_sep(a * a, k) - mu_a2
    sig_b = _filter2d_sep(b * b, k) - mu_b2
    sig_ab = _filter2d_sep(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * sig_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sig_a + sig_b + c2)
    return num / den


def calculate_ssim(orig: np.ndarray, comp: np.ndarray, max_value: float = 255.0) -> float:
    """Mean SSIM over pixels and channels (ImageMagick-compare analog)."""
    s = _ssim_map(jnp.asarray(orig), jnp.asarray(comp), max_value=max_value)
    return float(jnp.mean(s))


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2x(img):
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    x = img[:h, :w]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def calculate_ms_ssim(orig: np.ndarray, comp: np.ndarray, max_value: float = 255.0) -> float:
    """Multi-scale SSIM (Wang et al. 2003), 5 scales.

    The reference hardcodes 0.0 for MS-SSIM (`benchmark.rs:933,958` TODO);
    this is the real metric.
    """
    a = jnp.asarray(orig).astype(jnp.float32)
    b = jnp.asarray(comp).astype(jnp.float32)
    k = _gaussian_kernel(5, 1.5)
    c2 = (0.03 * max_value) ** 2
    vals = []
    for i, w in enumerate(_MSSSIM_WEIGHTS):
        if min(a.shape[0], a.shape[1]) < 11:
            break
        if i == len(_MSSSIM_WEIGHTS) - 1:
            s = _ssim_map(a, b, max_value=max_value)
            vals.append((float(jnp.mean(s)), w))
        else:
            mu_a = _filter2d_sep(a, k)
            mu_b = _filter2d_sep(b, k)
            # clamp variances: f32 cancellation can make them slightly
            # negative, which pushed per-scale contrast terms above 1
            sig_a = jnp.maximum(_filter2d_sep(a * a, k) - mu_a * mu_a, 0.0)
            sig_b = jnp.maximum(_filter2d_sep(b * b, k) - mu_b * mu_b, 0.0)
            sig_ab = _filter2d_sep(a * b, k) - mu_a * mu_b
            cs = jnp.mean((2 * sig_ab + c2) / (sig_a + sig_b + c2))
            vals.append((float(cs), w))
            a = _downsample2x(a)
            b = _downsample2x(b)
    out = 1.0
    for v, w in vals:
        out *= min(max(v, 1e-6), 1.0) ** w
    return float(out)
