"""Auto lane selection by stream size."""

from jxl_jax.codec.encode import pick_lanes


def test_small_images_keep_ratio_first_default():
    assert pick_lanes(1_200_000, 256) == 256  # 0.39 MP bench shape
    assert pick_lanes(100_000, 256) == 128  # tiny: shrink as before


def test_multi_mp_auto_grow():
    assert pick_lanes(6_100_000, 256) == 512  # ~2 MP
    assert pick_lanes(12_700_000, 256) == 1024  # ~4 MP


def test_explicit_lanes_pin():
    assert pick_lanes(12_700_000, 512) == 512
    assert pick_lanes(12_700_000, 128) == 128
    assert pick_lanes(12_700_000, 1024) == 1024
