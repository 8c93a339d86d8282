"""Quantization tables and distance scaling.

The reference's quantization lives in libjxl (adaptive quant field + per-
transform weights, exercised through `cjxl --distance`, docker_manager.rs:136).
This module provides the deterministic quant-step model of the codec:
steps are a pure function of (distance, channel, frequency), recomputed
identically by encoder and decoder — nothing is stored in the bitstream.

Model: step[c, u, v] = chan_base[c] * distance * freq_weight(u, v)
with a CSF-flavored radial frequency weight. The XYB channels have very
different dynamic ranges (X ~ +-0.03, Y/B ~ [0, 0.85]) so per-channel bases
differ; B is coded as (B - Y) residual — see codec.encode — which shrinks its
effective range and lets it take coarser steps.

NOTE on the JXL_JAX_* overrides below (CHAN_BASE, FREQ_STRENGTH,
RECON_BIAS, RDO_KAPPA): these are PAIRED encode+decode tuning knobs for
calibration runs (tools/rd_tune.py), not per-stream parameters — the
effective constants are NOT signaled in the container, so a stream encoded
under an override only decodes correctly in a process with the identical
environment. CHAN_BASE and FREQ_STRENGTH are additionally frozen at import
time. Production streams must use the defaults.
"""

import os
from functools import lru_cache

import jax.numpy as jnp
import numpy as np


def _env_floats(name: str, default):
    v = os.environ.get(name)
    if not v:
        return np.asarray(default, dtype=np.float32)
    return np.asarray([float(s) for s in v.split(",")], dtype=np.float32)


# Per-channel base steps at distance = 1 (X, Y, B-residual).
# Calibrated on the round-3 RD objective (bpp at matched PSNR over the
# bench set, tools/rd_tune.py — see docs/rd_position.md) jointly with
# FREQ_STRENGTH below, then scaled so d=1 lands at the cjxl --distance=1
# operating point (~38.2 dB on the noisy bench image, ~40 dB on the
# corpus set). JXL_JAX_CHAN_BASE / JXL_JAX_DC_BASE override (comma-
# separated triples) for tuning runs.
CHAN_BASE = _env_floats("JXL_JAX_CHAN_BASE", [0.0131, 0.0158, 0.0281])
DC_CHAN_BASE = _env_floats("JXL_JAX_DC_BASE", [0.0036, 0.0036, 0.0064])

# Frequency weighting strength: higher frequencies get coarser steps.
# MSE-optimal allocation is FLAT (equal per-coefficient distortion —
# reverse water-filling); the old 3.0 gave Nyquist steps 4x coarser than
# DC-adjacent ones, i.e. spent far too many bits on near-DC precision.
# 0.8 measured ~5% cheaper at matched PSNR than 1.5 and ~8% cheaper than
# 3.0 across the bench+corpus set (docs/rd_position.md); going fully flat
# (0.6) stopped paying. JXL_JAX_FREQ_STRENGTH overrides.
FREQ_STRENGTH = float(os.environ.get("JXL_JAX_FREQ_STRENGTH", "0.8"))


def distance_scale(distance: float) -> float:
    """Map cjxl-style distance to a linear step multiplier.

    scale = d for d <= 1, d^1.1 above: mildly super-linear so the high-
    distance rows of the reference grids (d up to 14, benchmark.rs:637;
    d up to 25, old_test_jxl.py:16) land at aggressively-degraded
    operating points like cjxl's near-linear distance->quant law, instead
    of saturating at "mediocre but fine".
    """
    d = max(float(distance), 1e-4)
    return d if d <= 1.0 else d**1.1


@lru_cache(maxsize=None)
def _freq_weight_np(n: int, m: int) -> np.ndarray:
    u = np.arange(n)[:, None] / n
    v = np.arange(m)[None, :] / m
    radial = np.sqrt(u * u + v * v) / np.sqrt(2.0)  # 0 at DC, 1 at Nyquist corner
    return (1.0 + FREQ_STRENGTH * radial**1.5).astype(np.float32)


@lru_cache(maxsize=None)
def ac_steps_np(distance: float, n: int = 8, m: int = 8) -> np.ndarray:
    """[3, n, m] AC quant steps (numpy, cached per (distance, size))."""
    w = _freq_weight_np(n, m)[None, :, :]
    steps = CHAN_BASE[:, None, None] * distance_scale(distance) * w
    return steps.astype(np.float32)


@lru_cache(maxsize=None)
def dc_steps_np(distance: float) -> np.ndarray:
    """[3] DC quant steps. DC uses a gentler distance response (DC banding
    is the most visible artifact), but still coarsens substantially at
    high d — libjxl's DC quant is near-linear in distance too."""
    d = max(float(distance), 1e-4)
    scale = d**0.8
    return (DC_CHAN_BASE * scale).astype(np.float32)


def ac_steps(distance: float, n: int = 8, m: int = 8) -> jnp.ndarray:
    return jnp.asarray(ac_steps_np(distance, n, m))


def dc_steps(distance: float) -> jnp.ndarray:
    return jnp.asarray(dc_steps_np(distance))


# --- traced-distance versions (used inside jit so one compiled encoder /
# decoder serves every distance of an RD sweep; only the tiny step tables
# are recomputed per call) -------------------------------------------------


def distance_scale_t(distance) -> jnp.ndarray:
    d = jnp.maximum(jnp.asarray(distance, jnp.float32), 1e-4)
    return jnp.where(d <= 1.0, d, d**1.1)


def ac_steps_t(distance, n: int = 8, m: int = 8) -> jnp.ndarray:
    """[3, n, m] AC steps from a (possibly traced) distance scalar."""
    w = jnp.asarray(_freq_weight_np(n, m))[None, :, :]
    return jnp.asarray(CHAN_BASE)[:, None, None] * distance_scale_t(distance) * w


def dc_steps_t(distance) -> jnp.ndarray:
    d = jnp.maximum(jnp.asarray(distance, jnp.float32), 1e-4)
    return jnp.asarray(DC_CHAN_BASE) * d**0.8


def quantize(coeffs: jnp.ndarray, steps: jnp.ndarray) -> jnp.ndarray:
    """Round-to-nearest quantization -> int32 indices."""
    return jnp.round(coeffs / steps).astype(jnp.int32)


def dequantize(q: jnp.ndarray, steps: jnp.ndarray) -> jnp.ndarray:
    return q.astype(jnp.float32) * steps


def ac_recon_bias() -> float:
    """AC reconstruction bias b: decoded coefficient = (q - b*sign(q)) * step.

    AC coefficients are Laplacian-ish, so the conditional mean of a
    quantization bin sits closer to zero than its midpoint; reconstructing
    at the biased point lowers MSE at identical rate (libjxl applies the
    same idea per-channel). Container v7+ streams only — the decoder gates
    on the stream version so v5/v6 files reproduce exactly. Tuned on the
    bench set (docs/rd_position.md); JXL_JAX_RECON_BIAS overrides."""
    import os

    return float(os.environ.get("JXL_JAX_RECON_BIAS", "0.10"))


def dequant_ac_biased(q: jnp.ndarray, steps: jnp.ndarray) -> jnp.ndarray:
    """Biased AC dequantization (encoder-side mirror of the decoder's v7
    reconstruction; see ac_recon_bias)."""
    qf = q.astype(jnp.float32)
    return (qf - ac_recon_bias() * jnp.sign(qf)) * steps
