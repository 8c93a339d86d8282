"""XYB opsin color transform (JPEG XL's perceptual color space).

The reference codec (libjxl, built inside the Docker image at
`benchmark-jpegxl/Dockerfile:40-43`) performs all lossy coding in XYB; the
thesis heuristics read XYB planes directly (luminance c=1 at
`proposals/homogeneity-partitioning.diff:65`, chroma c=0/c=2 at `:116-124`).

This module implements the forward/inverse transform as pure jnp ops:
sRGB u8/float -> linear RGB -> LMS-like opsin mixing (+bias, cbrt) -> XYB.
Everything is elementwise, so XLA fuses it into adjacent kernels: one
pass over the image.

Constants are the public JPEG XL opsin-absorbance values (ISO/IEC 18181-1).
"""

import jax.numpy as jnp
import numpy as _np

# Opsin absorbance matrix: linear RGB -> (L, M, S) mixing, rows = L/M/S.
# NUMPY constants, not jnp: module-level jnp.array would initialize the XLA
# backend at import time, which breaks `jax.distributed.initialize` (it
# must run before ANY backend use — tests/test_multihost.py). numpy
# operands constant-fold identically under jit.
OPSIN_MATRIX = _np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.55180986650955360],
    ],
    dtype=_np.float32,
)

OPSIN_BIAS = _np.float32(0.0037930732552754493)
CBRT_OPSIN_BIAS = _np.cbrt(OPSIN_BIAS)

_OPSIN_NP = _np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.55180986650955360],
    ],
    dtype=_np.float64,
)
_OPSIN_INV_NP = _np.linalg.inv(_OPSIN_NP)

# Inverse of OPSIN_MATRIX, computed in float64 then truncated to f32.
OPSIN_MATRIX_INV = _np.asarray(_OPSIN_INV_NP, dtype=_np.float32)

# Python-float coefficient tables for the elementwise channel mixes (must be
# host floats, not jax arrays: under jit, captured jax constants are staged
# as tracers and cannot be read back).
_OPSIN_COEF = [[float(_OPSIN_NP[i, j]) for j in range(3)] for i in range(3)]
_OPSIN_INV_COEF = [[float(_OPSIN_INV_NP[i, j]) for j in range(3)] for i in range(3)]


def srgb_to_linear(srgb):
    """sRGB electro-optical transfer function, input/output in [0, 1]."""
    srgb = srgb.astype(jnp.float32)
    return jnp.where(
        srgb <= 0.04045,
        srgb / 12.92,
        ((srgb + 0.055) / 1.055) ** 2.4,
    )


def linear_to_srgb(lin):
    lin = lin.astype(jnp.float32)
    return jnp.where(
        lin <= 0.0031308,
        lin * 12.92,
        1.055 * jnp.maximum(lin, 1e-12) ** (1.0 / 2.4) - 0.055,
    )


def _mix3(mat, v):
    """Explicit 3x3 channel mix as elementwise ops.

    Deliberately NOT a matmul/einsum: at default precision the GPU may run
    an f32 einsum in TF32 (~1e-3 relative error), too coarse for a color
    transform feeding ~1e-3 quant steps. Written as muls+adds it runs in
    full float32 and fuses with neighboring elementwise ops.
    """
    m = mat  # nested python-float lists
    c0, c1, c2 = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            m[0][0] * c0 + m[0][1] * c1 + m[0][2] * c2,
            m[1][0] * c0 + m[1][1] * c1 + m[1][2] * c2,
            m[2][0] * c0 + m[2][1] * c1 + m[2][2] * c2,
        ],
        axis=-1,
    )


def linear_rgb_to_xyb(rgb):
    """Linear RGB [..., 3] -> XYB [..., 3]."""
    lms = _mix3(_OPSIN_COEF, rgb.astype(jnp.float32)) + OPSIN_BIAS
    lms_g = jnp.cbrt(jnp.maximum(lms, 0.0)) - CBRT_OPSIN_BIAS
    l_, m_, s_ = lms_g[..., 0], lms_g[..., 1], lms_g[..., 2]
    x = 0.5 * (l_ - m_)
    y = 0.5 * (l_ + m_)
    b = s_
    return jnp.stack([x, y, b], axis=-1)


def xyb_to_linear_rgb(xyb):
    """XYB [..., 3] -> linear RGB [..., 3]."""
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    l_ = y + x
    m_ = y - x
    s_ = b
    lms_g = jnp.stack([l_, m_, s_], axis=-1)
    lms = (lms_g + CBRT_OPSIN_BIAS) ** 3 - OPSIN_BIAS
    return _mix3(_OPSIN_INV_COEF, lms)


def srgb_to_xyb(srgb):
    """sRGB [..., 3] in [0,1] -> XYB [..., 3]."""
    return linear_rgb_to_xyb(srgb_to_linear(srgb))


def xyb_to_srgb(xyb):
    """XYB [..., 3] -> sRGB [..., 3], clipped to [0,1]."""
    return jnp.clip(linear_to_srgb(xyb_to_linear_rgb(xyb)), 0.0, 1.0)
