"""Cross-validate the fused homogeneity kernels against a direct scalar
implementation of the C++ semantics from proposals/homogeneity-partitioning.diff."""

import jax.numpy as jnp
import numpy as np
import pytest

from jxl_jax.strategy.homogeneity import (
    ACS_DCT,
    ACS_DCT4X4,
    ACS_DCT4X8,
    ACS_DCT8X4,
    homogeneity_all_subblocks,
    homogeneity_partition,
    homogeneity_similarity_indices,
    laplacian_edge_threshold,
    partition_threshold,
)


# --- scalar reference (transliteration of the diff's algorithm) -------------
def _scalar_laplacian(y, x0, y0, xsize, ysize, bx, by):
    H, W = y.shape
    mask = [[0, -1, 0], [-1, -4, -1], [0, -1, 0]]
    out = np.zeros((ysize, xsize), np.float32)
    for i in range(by, ysize + by):
        for j in range(bx, xsize + bx):
            s = 0.0
            for k in (-1, 0, 1):
                for l in (-1, 0, 1):
                    cy, cx = i + k, j + l
                    if 0 <= x0 + cx < W and 0 <= y0 + cy < H:
                        s += y[y0 + cy, x0 + cx] * mask[k + 1][l + 1]
            out[i - by, j - bx] = s
    return out


def _scalar_crossings(lap, xsize, ysize, threshold):
    nh = 0
    for i in range(ysize):
        in_edge = False
        for j in range(xsize):
            if not in_edge and lap[i, j] > threshold:
                nh += 1
                in_edge = True
            elif in_edge and lap[i, j] <= threshold:
                in_edge = False
    avg_h = nh / ysize
    nv = 0
    for i in range(xsize):
        in_edge = False
        for j in range(ysize):
            if not in_edge and lap[j, i] > threshold:
                nv += 1
                in_edge = True
            elif in_edge and lap[j, i] <= threshold:
                in_edge = False
    avg_v = nv / xsize
    return int(avg_h + avg_v)  # size_t truncation


def _scalar_sml(y, x0, y0, xsize, ysize, bx, by):
    H, W = y.shape
    s = 0.0
    for i in range(by, ysize + by):
        for j in range(bx, xsize + bx):
            if x0 + j - 1 < 0 or x0 + j + 1 >= W or y0 + i - 1 < 0 or y0 + i + 1 >= H:
                continue
            p = y[y0 + i, x0 + j]
            s += abs(2 * p - y[y0 + i, x0 + j - 1] - y[y0 + i, x0 + j + 1]) + abs(
                2 * p - y[y0 + i - 1, x0 + j] - y[y0 + i + 1, x0 + j]
            )
    return s


def _scalar_colorfulness(xp, bp, x0, y0, xsize, ysize, bx, by):
    xs = xp[y0 + by : y0 + by + ysize, x0 + bx : x0 + bx + xsize]
    bs = bp[y0 + by : y0 + by + ysize, x0 + bx : x0 + bx + xsize]
    mean_x, mean_b = xs.mean(), bs.mean()
    var_x = ((xs - mean_x) ** 2).mean()
    var_b = ((bs - mean_b) ** 2).mean()
    return np.sqrt(var_x + var_b) + 0.3 * np.sqrt(mean_x**2 + mean_b**2)


def _scalar_homog(planes, x0, y0, xsize, ysize, bx, by, distance):
    xp, yp, bp = planes
    t = laplacian_edge_threshold(distance)
    lap = _scalar_laplacian(yp, x0, y0, xsize, ysize, bx, by)
    zc = _scalar_crossings(lap, xsize, ysize, t)
    sml = _scalar_sml(yp, x0, y0, xsize, ysize, bx, by)
    col = _scalar_colorfulness(xp, bp, x0, y0, xsize, ysize, bx, by)
    return zc + sml + col


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(5)
    h, w = 32, 40
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yp = 0.4 + 0.3 * np.sin(xx / 5) + 0.1 * rng.normal(size=(h, w)).astype(np.float32)
    xp = 0.01 * rng.normal(size=(h, w)).astype(np.float32)
    bp = yp * 0.9 + 0.05 * rng.normal(size=(h, w)).astype(np.float32)
    return np.stack([xp, yp, bp]).astype(np.float32)


SUB_GEOMS = {
    "h1": (8, 4, 0, 0),
    "h2": (8, 4, 0, 4),
    "v1": (4, 8, 0, 0),
    "v2": (4, 8, 4, 0),
    "q00": (4, 4, 0, 0),
    "q11": (4, 4, 4, 4),
    "q01": (4, 4, 4, 0),
    "q10": (4, 4, 0, 4),
}  # name -> (xsize, ysize, bx, by)


def test_homogeneity_matches_scalar(planes):
    d = 1.0
    fused = homogeneity_all_subblocks(jnp.asarray(planes), d)
    for name, (xsize, ysize, bx, by) in SUB_GEOMS.items():
        got = np.asarray(fused[name])
        for byy in range(planes.shape[1] // 8):
            for bxx in range(planes.shape[2] // 8):
                want = _scalar_homog(
                    planes, bxx * 8, byy * 8, xsize, ysize, bx, by, d
                )
                assert got[byy, bxx] == pytest.approx(want, rel=1e-4), (
                    name,
                    byy,
                    bxx,
                )


def test_thresholds_match_reference():
    assert laplacian_edge_threshold(1.0) == 0.15
    assert laplacian_edge_threshold(2.0) == 0.15
    assert laplacian_edge_threshold(5.0) == 0.25
    assert laplacian_edge_threshold(10.5) == 0.40
    assert partition_threshold(1.0) == 1.50
    assert partition_threshold(3.0) == 1.50
    assert partition_threshold(5.0) == 1.60
    assert partition_threshold(12.0) == 1.80


def test_partition_decision_rule():
    t = partition_threshold(5.0)  # 1.6
    mk = lambda v: jnp.full((1, 1), v, jnp.float32)  # noqa: E731
    # r_d dominates
    out = homogeneity_partition(mk(2.0), mk(1.9), mk(1.7), 5.0)
    assert int(out[0, 0]) == ACS_DCT4X4
    # r_h biggest and over threshold
    out = homogeneity_partition(mk(1.7), mk(1.0), mk(1.0), 5.0)
    assert int(out[0, 0]) == ACS_DCT8X4
    # r_v biggest
    out = homogeneity_partition(mk(1.0), mk(1.7), mk(1.0), 5.0)
    assert int(out[0, 0]) == ACS_DCT4X8
    # nothing over threshold
    out = homogeneity_partition(mk(1.3), mk(1.2), mk(1.1), 5.0)
    assert int(out[0, 0]) == ACS_DCT
    # NaN keeps DCT (degenerate 0/0 blocks)
    out = homogeneity_partition(mk(float("nan")), mk(float("nan")), mk(float("nan")), 5.0)
    assert int(out[0, 0]) == ACS_DCT
    del t


def test_similarity_indices_on_structured_block(planes):
    r_h, r_v, r_d = homogeneity_similarity_indices(jnp.asarray(planes), 1.0)
    assert r_h.shape == (4, 5)
    # ratios are >= 1 by construction (max/min) where finite
    finite = np.isfinite(np.asarray(r_h))
    assert np.all(np.asarray(r_h)[finite] >= 1.0)
