"""Adaptive quantization field — per-block masking-based step multipliers.

libjxl's VarDCT mode modulates quantization per 8x8 block with a
psychovisual masking field (the reference exercises it implicitly through
`cjxl --distance`). Version here: local activity of the XYB luma
plane (the same Laplacian-energy signal the thesis's homogeneity statistics
use) drives a per-block multiplier — busy blocks hide error and take
coarser steps, smooth blocks take finer ones.

The multiplier is signaled: quantized to 16 exponential levels, one token
per 8x8 block (context CTX_QF), so the decoder reproduces the exact step
field without recomputing masking from (unavailable) original pixels.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

QF_LEVELS = 16
# exponential ladder centered at 1.0: 0.55 .. 2.6
QF_TABLE = np.exp(np.linspace(np.log(0.55), np.log(2.6), QF_LEVELS)).astype(np.float32)
# nearest-to-1.0 index: the constant field low efforts (e <= 2) signal
QF_CENTER_IDX = int(np.argmin(np.abs(QF_TABLE - 1.0)))
_QF_CENTER = QF_CENTER_IDX

# activity -> multiplier response
_ACT_REF = 0.02  # luma Laplacian energy of "moderately textured" content
_STRENGTH = 0.55


def quant_field(y_plane: jnp.ndarray) -> jnp.ndarray:
    """[Hp, Wp] luma -> per-block multiplier indices [nby, nbx] int32."""
    h, w = y_plane.shape
    yp = jnp.pad(y_plane, 1, mode="edge")
    c = yp[1:-1, 1:-1]
    lap = jnp.abs(
        4.0 * c - yp[:-2, 1:-1] - yp[2:, 1:-1] - yp[1:-1, :-2] - yp[1:-1, 2:]
    )
    act = lap.reshape(h // 8, 8, w // 8, 8).mean(axis=(1, 3))  # [nby, nbx]
    mul = jnp.exp2(_STRENGTH * jnp.log2(1.0 + act / _ACT_REF) - _STRENGTH * 1.0)
    # snap to the ladder
    table = jnp.asarray(QF_TABLE)
    idx = jnp.argmin(jnp.abs(jnp.log(mul)[..., None] - jnp.log(table)), axis=-1)
    return idx.astype(jnp.int32)


def qf_multiplier(idx: jnp.ndarray) -> jnp.ndarray:
    """Indices -> multipliers (both sides of the codec use this table)."""
    return jnp.asarray(QF_TABLE)[idx]
