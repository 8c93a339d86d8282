"""Adaptive quantization field tests."""

import jax.numpy as jnp
import numpy as np

from jxl_jax.strategy.acs import effective_multiplier, group_min_multiplier
from jxl_jax.transforms.adaptive import QF_LEVELS, QF_TABLE, qf_multiplier, quant_field


def test_qf_table_monotonic_and_centered():
    assert len(QF_TABLE) == QF_LEVELS
    assert np.all(np.diff(QF_TABLE) > 0)
    assert QF_TABLE[0] < 1.0 < QF_TABLE[-1]


def test_quant_field_busy_vs_smooth():
    rng = np.random.default_rng(0)
    smooth = np.full((32, 32), 0.5, np.float32)
    busy = (0.5 + 0.3 * rng.normal(size=(32, 32))).astype(np.float32)
    y = np.concatenate([smooth, busy], axis=1)  # [32, 64]
    idx = np.asarray(quant_field(jnp.asarray(y)))
    mul = np.asarray(qf_multiplier(jnp.asarray(idx)))
    # busy half must quantize coarser than the smooth half
    assert mul[:, 4:].mean() > mul[:, :4].mean() * 1.3
    assert idx.shape == (4, 8)


def test_group_min_multiplier():
    qf = jnp.asarray(
        np.array([[1.0, 2.0, 3.0, 4.0], [0.5, 1.0, 1.0, 1.0]], np.float32)
    )
    g = np.asarray(group_min_multiplier(qf, 2))
    assert g[0, 0] == g[0, 1] == g[1, 0] == g[1, 1] == 0.5
    assert g[0, 2] == 1.0


def test_effective_multiplier_uses_group_min_for_merges():
    qf = jnp.ones((4, 4), jnp.float32).at[0, 0].set(0.6)
    acs = jnp.zeros((4, 4), jnp.int32).at[:2, :2].set(4)  # 16x16 merged group
    eff = np.asarray(effective_multiplier(qf, acs))
    assert np.allclose(eff[:2, :2], 0.6)
    assert np.allclose(eff[2:, 2:], 1.0)
