"""Fused per-pair metric battery: every sweep metric in ONE device program.

The reference computes its metric battery with five separate tool
invocations per grid point (`benchmark.rs:895-975`: host MSE loop,
ImageMagick SSIM, two in-container binaries). A naive port costs six
dispatch+sync round trips per pair. This computes MSE, SSIM, MS-SSIM,
Butteraugli(max, 3-norm) and the SSIMULACRA2 feature error in one jit and
fetches seven scalars with a single get; decoded pixels never leave the
device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jxl_jax.metrics.perceptual import (
    _S2_GAIN,
    _S2_POW,
    _S2_W_CH,
    _S2_W_COMP,
    _S2_W_SCALE,
    _butteraugli_map,
    _ssimulacra2_features,
)
from jxl_jax.metrics.quality import (
    _MSSSIM_WEIGHTS,
    _downsample2x,
    _filter2d_sep,
    _gaussian_kernel,
    _ssim_map,
    psnr_from_mse,
)


def _ms_ssim_t(a, b, max_value: float = 255.0):
    """Traceable MS-SSIM (same math as quality.calculate_ms_ssim)."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    k = _gaussian_kernel(5, 1.5)
    c2 = (0.03 * max_value) ** 2
    out = jnp.float32(1.0)
    for i, w in enumerate(_MSSSIM_WEIGHTS):
        if min(a.shape[0], a.shape[1]) < 11:
            break
        if i == len(_MSSSIM_WEIGHTS) - 1:
            v = jnp.mean(_ssim_map(a, b, max_value=max_value))
        else:
            mu_a = _filter2d_sep(a, k)
            mu_b = _filter2d_sep(b, k)
            sig_a = jnp.maximum(_filter2d_sep(a * a, k) - mu_a * mu_a, 0.0)
            sig_b = jnp.maximum(_filter2d_sep(b * b, k) - mu_b * mu_b, 0.0)
            sig_ab = _filter2d_sep(a * b, k) - mu_a * mu_b
            v = jnp.mean((2 * sig_ab + c2) / (sig_a + sig_b + c2))
        out = out * jnp.clip(v, 1e-6, 1.0) ** w
        if i < len(_MSSSIM_WEIGHTS) - 1:
            a = _downsample2x(a)
            b = _downsample2x(b)
    return out


def _battery_core(orig_u8, comp_u8):
    a = jnp.asarray(orig_u8)
    b = jnp.asarray(comp_u8)
    d = a.astype(jnp.float32) - b.astype(jnp.float32)
    mse = jnp.mean(d * d)
    ssim = jnp.mean(_ssim_map(a, b))
    ms_ssim = _ms_ssim_t(a, b)
    ba = _butteraugli_map(a, b)
    ba_max = jnp.max(ba)
    ba_p3 = jnp.mean(ba**3) ** (1.0 / 3.0)
    f = _ssimulacra2_features(a, b)
    w = (
        jnp.asarray(_S2_W_SCALE)[:, None, None, None]
        * jnp.asarray(_S2_W_CH)[None, :, None, None]
        * jnp.asarray(_S2_W_COMP)[None, None, :, :]
    )
    s2_err = jnp.sum(f * w)
    return jnp.stack([mse, ssim, ms_ssim, ba_max, ba_p3, s2_err])


_battery = jax.jit(_battery_core)


@jax.jit
def _battery_grid(orig_u8, comp_stack):
    """Battery for a whole RD row against one original: [N, H, W, 3]
    decoded stack -> [N, 6]. lax.map keeps one compiled body and runs the
    points device-sequentially — ONE dispatch + one [N, 6] fetch for the
    row instead of N of each."""
    return jax.lax.map(lambda c: _battery_core(orig_u8, c), comp_stack)


def _metrics_dict(v) -> dict:
    mse = float(v[0])
    return {
        "mse": mse,
        "psnr": psnr_from_mse(mse),
        "ssim": float(v[1]),
        "ms_ssim": float(v[2]),
        "butteraugli": float(v[3]),
        "butteraugli_pnorm": float(v[4]),
        "ssimulacra2": 100.0 - _S2_GAIN * max(float(v[5]) - 2e-3, 0.0) ** _S2_POW,
    }


def metric_battery_grid_async(orig, comp_stack):
    """Dispatch the whole-row battery now; returns finalize() -> list of
    metric dicts (one per row point)."""
    vecs = _battery_grid(orig, comp_stack)

    def finalize() -> list:
        v = jax.device_get(vecs)
        return [_metrics_dict(v[i]) for i in range(v.shape[0])]

    return finalize


def metric_battery_async(orig, comp):
    """Dispatch the battery now; returns finalize() -> metrics dict.

    Lets the sweep driver pipeline a whole grid row: dispatch every
    decode + battery back-to-back (device work for point i+1 overlaps the
    scalar fetch of point i), then finalize in order."""
    vec = _battery(orig, comp)

    def finalize() -> dict:
        return _metrics_dict(jax.device_get(vec))

    return finalize


def metric_battery(orig, comp) -> dict:
    """All sweep metrics for one (orig, comp) pair; accepts host or device
    arrays. One dispatch, one scalar-vector fetch."""
    return metric_battery_async(orig, comp)()
