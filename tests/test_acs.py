"""AC-strategy machinery tests: layout invertibility + search sanity +
variant round-trips through the full codec."""

import jax.numpy as jnp
import numpy as np
import pytest

from jxl_jax.codec.config import CodecConfig, Strategy
from jxl_jax.codec.decode import decode_bytes
from jxl_jax.codec.encode import encode_image
from jxl_jax.metrics import calculate_psnr
from jxl_jax.strategy.acs import (
    ACS_DCT,
    ACS_DCT4X4,
    ACS_DCT16X16,
    ACS_DCT32X32,
    ACS_DCT64X64,
    MERGE_LADDER,
    candidates_merged,
    candidates_sub8,
    merged_step_slots,
    reassemble_merged,
    search_acs,
    steps_field,
    sub8_step_grids,
)
from jxl_jax.transforms.dct import dct2d
from tests.conftest import make_test_image


def _planes(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, 0.1, (3, h, w)).astype(np.float32))


def _blocks(planes):
    c, h, w = planes.shape
    return planes.reshape(c, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)


def test_sub8_candidates_dc_invariant():
    """Every sub-8 strategy's implied DC equals the 8x8 block mean * 8."""
    planes = _planes(16, 16)
    blocks = _blocks(planes)
    cands = candidates_sub8(blocks)
    dc8 = np.asarray(jnp.mean(blocks, axis=(-2, -1)) * 8.0)
    # For DCT, the (0,0) coefficient was zeroed but DCT's own DC = mean*8:
    c8 = np.asarray(dct2d(blocks))
    np.testing.assert_allclose(c8[..., 0, 0], dc8, atol=1e-4)
    # For the split strategies the DC lives in the (zeroed) M00/m0 slot; the
    # stored (0,4)/(4,0)/(4,4) slots plus DC must reproduce the sub-DCs.
    assert np.allclose(np.asarray(cands[ACS_DCT])[..., 0, 0], 0.0)
    assert np.allclose(np.asarray(cands[ACS_DCT4X4])[..., 0, 0], 0.0)


def test_merged_candidates_shape_and_lowfreq():
    planes = _planes(64, 96)
    slots16 = candidates_merged(planes, 16)
    assert slots16.shape == (3, 4, 6, 2, 2, 8, 8)
    # strided map: the zeroed lowfreq corner C[:2, :2] lands exactly on the
    # (0, 0) slot of every sub-block — the one position the token layout
    # never codes (the DC plane stands in for it)
    s = np.asarray(slots16)
    assert np.allclose(s[:, :, :, :, :, 0, 0], 0.0)
    # and nothing else was zeroed: slot (ky,kx)[u,v] == C[u*2+ky, v*2+kx]
    from jxl_jax.transforms.dct import dct2d as _d

    tiles = planes[:, :64, :96].reshape(3, 4, 16, 6, 16).transpose(0, 1, 3, 2, 4)
    c = np.asarray(_d(tiles))
    np.testing.assert_allclose(s[0, 0, 0, 1, 0, 3, 2], c[0, 0, 0, 3 * 2 + 1, 2 * 2 + 0], rtol=1e-5)


def test_merged_roundtrip_exact_on_smooth():
    """For content whose DC plane captures the lowfreq exactly (flat),
    reassemble_merged inverts candidates_merged + DC injection."""
    planes = jnp.full((3, 32, 32), 0.37, jnp.float32)
    slots = candidates_merged(planes, 16)
    dcb = jnp.full((3, 2, 2, 2, 2), 0.37 * 8.0, jnp.float32)
    tiles = reassemble_merged(slots, dcb)
    np.testing.assert_allclose(np.asarray(tiles), 0.37, atol=1e-4)


def test_steps_field_matches_merged_slots():
    """For a 16x16-merged 2x2 group, the per-block step field must equal the
    n x n step-table tiles, sub-positioned by (by % k, bx % k)."""
    acs = jnp.asarray(
        np.array(
            [
                [4, 4, 0, 1],
                [4, 4, 2, 3],
            ],
            np.int32,
        )
    )
    eff = jnp.ones((2, 4), jnp.float32)
    field = np.asarray(steps_field(1.0, acs, eff))  # [3, 2, 4, 8, 8]
    slots16 = np.asarray(merged_step_slots(1.0, 16))  # [3, 2, 2, 8, 8]
    sub8 = np.asarray(sub8_step_grids(1.0))
    for ky in range(2):
        for kx in range(2):
            np.testing.assert_array_equal(field[:, ky, kx], slots16[:, ky, kx])
    for j, sid in enumerate((0, 1, 2, 3)):
        by, bx = divmod(j, 2)
        np.testing.assert_array_equal(field[:, by, bx + 2], sub8[sid])


def test_step_grids_positive():
    assert (np.asarray(sub8_step_grids(1.0)) > 0).all()
    for n, _sid, _e in MERGE_LADDER:
        s = np.asarray(merged_step_slots(1.0, n))
        assert s.shape == (3, n // 8, n // 8, 8, 8)
        assert (s > 0).all()


def test_search_flat_prefers_merges():
    planes = jnp.full((3, 64, 64), 0.5, jnp.float32)
    blocks = _blocks(planes)
    acs, qstorage, qsteps = search_acs(
        blocks, planes, 1.0, effort=7, hook_a=False, hook_b=False
    )
    # flat content: everything merges to the biggest transform effort 7
    # allows (64x64 covers the whole image)
    assert int(jnp.sum(acs == ACS_DCT64X64)) == 64
    assert int(jnp.abs(qstorage).max()) == 0  # no AC energy


def test_search_flat_effort6_stops_at_16():
    planes = jnp.full((3, 64, 64), 0.5, jnp.float32)
    blocks = _blocks(planes)
    acs, _, _ = search_acs(blocks, planes, 1.0, effort=6, hook_a=False, hook_b=False)
    assert int(jnp.sum(acs == ACS_DCT16X16)) == 64  # e6 gates 32+


def test_search_textured_mixes_strategies():
    from jxl_jax.strategy.acs import N_STRATEGIES

    img = make_test_image(64, 64, seed=11).astype(np.float32) / 255.0
    planes = jnp.asarray(np.transpose(img, (2, 0, 1)))
    blocks = _blocks(planes)
    acs, _, _ = search_acs(blocks, planes, 1.0, effort=7, hook_a=False, hook_b=False)
    assert acs.shape == (8, 8)
    assert int(acs.min()) >= 0 and int(acs.max()) <= N_STRATEGIES - 1


@pytest.mark.parametrize(
    "n,sid,effort",
    [
        (64, 6, 7),
        pytest.param(128, 7, 8, marks=pytest.mark.slow),
        pytest.param(256, 8, 9, marks=pytest.mark.slow),
    ],
)
def test_large_merge_roundtrip(n, sid, effort):
    """Content that is free at every scale (flat) must ladder all the way
    up to the largest transform the effort allows, and a same-size gradient
    must still round-trip through the full codec (the merge decision on a
    gradient is a legitimate rate call — the local ramp amplitude grows
    with tile size, so bigger merges may lose; flat content always wins)."""
    planes = jnp.full((3, n, n), 0.42, jnp.float32)
    blocks = _blocks(planes)
    acs, _, _ = search_acs(
        blocks, planes, 1.0, effort=effort, hook_a=False, hook_b=False
    )
    assert int(jnp.sum(acs == sid)) == (n // 8) ** 2, np.asarray(acs)

    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    lum = 0.35 + 0.25 * (xx + yy) / (2 * n)
    img = (np.stack([lum, lum, lum], axis=-1) * 255).astype(np.uint8)
    data = encode_image(img, CodecConfig(distance=1.0, effort=effort))
    out = decode_bytes(data)
    assert calculate_psnr(img, out) > 38.0


@pytest.mark.parametrize(
    "strategy",
    [
        Strategy.BASELINE,
        Strategy.HOMOGENEITY_PARTITIONING,
        Strategy.HOMOGENEITY_FACTORED_ENTROPY,
        Strategy.COMBINED,
    ],
)
def test_codec_roundtrip_all_strategies(strategy):
    img = make_test_image(64, 80, seed=3)
    cfg = CodecConfig(distance=1.0, effort=7, strategy=strategy)
    data = encode_image(img, cfg)
    out = decode_bytes(data)
    psnr = calculate_psnr(img, out)
    assert psnr > 32.0, (strategy, psnr)


@pytest.mark.slow
def test_effort_gates_block_sizes():
    img = make_test_image(64, 64, seed=4)
    sizes = {}
    for effort in (3, 5, 7):
        data = encode_image(img, CodecConfig(distance=2.0, effort=effort))
        out = decode_bytes(data)
        sizes[effort] = len(data)
        assert calculate_psnr(img, out) > 30.0
    # higher effort never produces a meaningfully larger stream on this
    # content (the search is rate-PROXY driven, so a few bytes of slack:
    # a merge the proxy likes can cost slightly more real rANS bits)
    assert sizes[7] <= sizes[5] + 128
    assert sizes[5] <= sizes[3] + 128


@pytest.mark.slow
def test_two_pass_rate_model_improves_e8():
    """Effort >= 8 re-runs the AC-strategy search with measured per-symbol
    bit costs (two-pass); on textured content this must produce a
    different, never-larger bitstream than the proxy-driven e7 at the same
    quality."""
    img = make_test_image(96, 128, seed=5)
    d7 = encode_image(img, CodecConfig(distance=1.0, effort=7))
    d8 = encode_image(img, CodecConfig(distance=1.0, effort=8))
    assert d7[64:] != d8[64:]  # differ beyond the header bytes
    assert len(d8) <= len(d7) + 16
    out7 = decode_bytes(d7)
    out8 = decode_bytes(d8)
    assert abs(calculate_psnr(img, out8) - calculate_psnr(img, out7)) < 1.0


def test_flat_image_with_merges_is_tiny_and_exact():
    img = np.full((64, 64, 3), 170, np.uint8)
    data = encode_image(img, CodecConfig(distance=1.0, effort=7))
    out = decode_bytes(data)
    assert calculate_psnr(img, out) > 40.0
    assert len(data) * 8 / (64 * 64) < 2.0
