"""Edge-preserving filter (EPF) — decode-side deblocking/deringing.

libjxl's adaptive loop filter (part of the VarDCT pipeline the reference
invokes through cjxl/djxl) smooths quantization artifacts while keeping
edges: neighbor contributions are down-weighted when they differ more than
the expected quantization noise. Version here: one vectorized pass of
a 4-neighbor cross kernel over the XYB planes, with per-pixel sigma derived
from the signaled quant field (coarser blocks -> stronger smoothing) —
pure elementwise ops, fused by XLA into the decode pipeline.
"""

from __future__ import annotations

import jax.numpy as jnp

# base sigma per channel at distance=1, qf=1 (XYB units); B uses the Y value
# since it is coded as a residual on top of Y.
_EPF_BASE = (0.0035, 0.0045, 0.008)
_EPF_DISTANCE_POW = 0.8


def epf_sigma(eff_mul: jnp.ndarray, distance, height: int, width: int) -> jnp.ndarray:
    """Per-pixel sigma field from the per-block multipliers.

    The low-distance RAMP fades the filter out as d -> 0.5: at low
    distance most high-frequency content is coded, so smoothing removes
    signal, not artifacts (measured in docs/epf_ab.md — EPF at full
    strength cost -0.26 dB on the noisy bench image at d=1 while gaining
    +0.1..0.2 dB everywhere at d >= 4; the ramp keeps ~all of the d >= 4
    gain and ~none of the d = 1 loss). Same spirit as libjxl scaling EPF
    iterations/strength down at low distance."""
    d = jnp.maximum(jnp.asarray(distance, jnp.float32), 1e-4)
    ramp = jnp.clip(1.0 - jnp.exp(-(d - 0.5) / 1.2), 0.0, 1.0)
    strength = d**_EPF_DISTANCE_POW * ramp
    sig_block = eff_mul * strength  # [nby, nbx]
    sig_pix = jnp.repeat(jnp.repeat(sig_block, 8, axis=0), 8, axis=1)
    return sig_pix[:height, :width]


def epf_filter_ext(planes_ext: jnp.ndarray, sig_pix: jnp.ndarray) -> jnp.ndarray:
    """Core filter given 1-pixel halos: planes_ext [3, H+2, W+2] -> [3, H, W].

    The halo rows/cols come from edge replication on a single device, or
    from neighbor-device exchange (ppermute) when the image is sharded —
    see distributed.sharded.sharded_epf.
    """
    h, w = planes_ext.shape[-2] - 2, planes_ext.shape[-1] - 2
    out = []
    for c in range(3):
        xp = planes_ext[c]
        x = xp[1 : 1 + h, 1 : 1 + w]
        sigma = sig_pix * _EPF_BASE[c]
        acc = x
        wacc = jnp.ones_like(x)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nb = xp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            t = jnp.abs(nb - x) / jnp.maximum(sigma, 1e-8)
            wgt = jnp.maximum(0.0, 1.0 - 0.5 * t * t)
            acc = acc + wgt * nb
            wacc = wacc + wgt
        out.append(acc / wacc)
    return jnp.stack(out)


def epf_apply(planes: jnp.ndarray, eff_mul: jnp.ndarray, distance) -> jnp.ndarray:
    """planes: [3, Hp, Wp] XYB (B as residual); eff_mul: [nby, nbx] per-block
    step multipliers; distance: traced scalar. Returns filtered planes."""
    h, w = planes.shape[-2:]
    sig_pix = epf_sigma(eff_mul, distance, h, w)
    planes_ext = jnp.pad(planes, ((0, 0), (1, 1), (1, 1)), mode="edge")
    return epf_filter_ext(planes_ext, sig_pix)
