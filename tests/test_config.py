"""Strategy activation-matrix parity (SURVEY §2.4) + config invariants."""

import pytest

from jxl_jax.codec.config import CodecConfig, Strategy


def test_strategy_activation_matrix():
    # | variant | hook A | hook B |  (SURVEY §2.4). hook_a is a 3-level
    # int since round 5 (0 off / 1 unconditional / 2 RD-gated); truthiness
    # preserves the original matrix.
    assert not Strategy.BASELINE.hook_a
    assert Strategy.BASELINE.hook_b is False
    assert Strategy.HOMOGENEITY_PARTITIONING.hook_a == 1
    assert Strategy.HOMOGENEITY_PARTITIONING.hook_b is False
    assert not Strategy.HOMOGENEITY_FACTORED_ENTROPY.hook_a
    assert Strategy.HOMOGENEITY_FACTORED_ENTROPY.hook_b is True
    assert Strategy.COMBINED.hook_a == 1
    assert Strategy.COMBINED.hook_b is True
    assert Strategy.HOMOGENEITY_RD_GATED.hook_a == 2
    assert Strategy.HOMOGENEITY_RD_GATED.hook_b is False


def test_effort_gates():
    """Effort ladder single source of truth: strategy/acs.MERGE_LADDER
    minimum efforts match the documented semantics (config.py)."""
    from jxl_jax.strategy.acs import MERGE_LADDER

    min_effort = {n: e for n, _sid, e in MERGE_LADDER}
    assert min_effort[16] == 6
    assert min_effort[32] == 7 and min_effort[64] == 7
    assert min_effort[128] == 8 and min_effort[256] == 9


@pytest.mark.slow
def test_effort_ladder_distinct_bitstreams():
    """Every legacy-grid effort row is a distinct operating point
   : e1/e3/e5/e7 produce different bitstreams."""
    from jxl_jax.codec.encode import encode_image
    from tests.conftest import make_test_image

    img = make_test_image(64, 96, seed=11)
    streams = {
        e: encode_image(img, CodecConfig(distance=1.0, effort=e))
        for e in (1, 3, 5, 7)
    }
    blobs = list(streams.values())
    assert len({b for b in blobs}) == len(blobs), "efforts must differ"
    # the fast path must actually be smaller work, not just different:
    # e1 skips CfL/AQ/RDO so it codes MORE bits than e5+
    assert len(streams[1]) > len(streams[5])


def test_config_hashable():
    # used as jit static argument material
    hash(CodecConfig())
    assert CodecConfig() == CodecConfig(distance=1.0)


def test_distance_floor_roundtrip():
    import numpy as np

    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.codec.encode import encode_image
    from jxl_jax.metrics import calculate_psnr
    from tests.conftest import make_test_image

    img = make_test_image(32, 32, seed=5)
    data = encode_image(img, CodecConfig(distance=0.0, effort=3))
    out = decode_bytes(data)
    assert calculate_psnr(img, out) > 40.0
    assert out.dtype == np.uint8
