"""Homogeneity statistics — the thesis's proposals, as one fused computation.

Re-implements, as array code, the ~220-line helper block that all three
`proposals/*.diff` files insert into libjxl's `enc_ac_strategy.cc`:

- `CalculateLaplacianFilter` (homogeneity-partitioning.diff:57-81):
  3x3 Laplacian {{0,-1,0},{-1,-4,-1},{0,-1,0}} on XYB luma (c=1), zero
  outside the image.
- `CalculateNumZeroCrossings` (diff:17-55): threshold-crossing run counts
  along rows + columns, averaged per row/col and summed; the C++ returns
  `size_t`, truncating the float sum — mirrored here with floor().
- `CalculateSumModifiedLaplacian` (diff:83-105): sum of |2p-l-r| + |2p-u-d|
  on luma, skipping pixels whose 4-neighborhood leaves the image.
- `CalculateColorfulness` (diff:107-151): sqrt(var_x + var_b) +
  0.3*sqrt(mean_x^2 + mean_b^2) over the X (c=0) and B (c=2) planes.
- `CalculateHomogeneity` (diff:153-181) = crossings + SML + colorfulness,
  with the quality-adaptive Laplacian threshold (0.25; 0.40 if d>10;
  0.15 if d<=2).
- `CalculateHomogeneitySimilarityIndices` (diff:183-211): ratios
  r_h, r_v, r_d = max/min homogeneity over the 8x4 / 4x8 / diagonal-4x4
  splits of each 8x8 block. NOTE the reference's diagonal sums are
  `h(a) + h(b) / 2` — operator precedence halves only the second term;
  mirrored bit-for-bit since it is the algorithm the thesis evaluated.
- `HomogeneityPartition` (diff:213-235): threshold 1.60 (1.80 if d>10,
  1.50 if d<=3); r_d -> DCT4X4, r_h -> DCT8X4, r_v -> DCT4X8, else DCT.

Where the C++ computes these per 8x8 block inside a scalar loop with a
malloc/free per call (diff:160,178 — SURVEY §3.4 hot spot), this module
computes every statistic for *all* blocks of an image at once: the Laplacian
and SML maps are two convolutions over the luma plane, the per-sub-block
sums are static block-space slices, and the run counting is a shifted
boolean AND — all VPU-friendly elementwise work, no gather/scatter.
"""

from __future__ import annotations

import jax.numpy as jnp

# AC strategy ids shared with the codec (subset used by the partition rule).
ACS_DCT = 0
ACS_DCT4X4 = 1
ACS_DCT8X4 = 2
ACS_DCT4X8 = 3


def laplacian_edge_threshold(distance):
    """diff:163-168. Accepts python floats or traced jnp scalars (the codec
    traces distance so one compiled encoder serves a whole RD sweep)."""
    d = jnp.asarray(distance, jnp.float32)
    return jnp.where(d > 10.0, 0.40, jnp.where(d <= 2.0, 0.15, 0.25))


def partition_threshold(distance):
    """diff:219-224. Traced-distance friendly like laplacian_edge_threshold."""
    d = jnp.asarray(distance, jnp.float32)
    return jnp.where(d > 10.0, 1.80, jnp.where(d <= 3.0, 1.50, 1.60))


def _laplacian_map(y_plane: jnp.ndarray) -> jnp.ndarray:
    """3x3 Laplacian with zero padding (out-of-image pixels contribute 0)."""
    yp = jnp.pad(y_plane, 1)
    c = yp[1:-1, 1:-1]
    up, down = yp[:-2, 1:-1], yp[2:, 1:-1]
    left, right = yp[1:-1, :-2], yp[1:-1, 2:]
    return -4.0 * c - up - down - left - right


def _sml_map(y_plane: jnp.ndarray) -> jnp.ndarray:
    """|2p-l-r| + |2p-u-d|, zero at pixels whose neighborhood exits the image
    (the C++ `continue`s those, diff:91-93)."""
    h, w = y_plane.shape
    yp = jnp.pad(y_plane, 1)
    c = yp[1:-1, 1:-1]
    up, down = yp[:-2, 1:-1], yp[2:, 1:-1]
    left, right = yp[1:-1, :-2], yp[1:-1, 2:]
    sml = jnp.abs(2.0 * c - left - right) + jnp.abs(2.0 * c - up - down)
    mask = jnp.zeros((h, w), bool).at[1 : h - 1, 1 : w - 1].set(True)
    return jnp.where(mask, sml, 0.0)


def _to_blocks(plane: jnp.ndarray) -> jnp.ndarray:
    """[Hp, Wp] -> [nby, nbx, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


# The 8 sub-block geometries of CalculateHomogeneitySimilarityIndices:
# (ys, xs, by, bx) slices of the 8x8 block.
_SUBBLOCKS = {
    "h1": (slice(0, 4), slice(0, 8)),  # 8x4 top     (xsize=8, ysize=4, by=0)
    "h2": (slice(4, 8), slice(0, 8)),  # 8x4 bottom  (by=4)
    "v1": (slice(0, 8), slice(0, 4)),  # 4x8 left    (xsize=4, bx=0)
    "v2": (slice(0, 8), slice(4, 8)),  # 4x8 right   (bx=4)
    "q00": (slice(0, 4), slice(0, 4)),
    "q11": (slice(4, 8), slice(4, 8)),
    "q01": (slice(0, 4), slice(4, 8)),
    "q10": (slice(4, 8), slice(0, 4)),
}


def _zero_crossings(lap_blocks: jnp.ndarray, rows: slice, cols: slice, threshold: float):
    """Average row + column threshold-run counts per sub-block, floored like
    the C++ size_t return (diff:17-55). lap_blocks: [nby, nbx, 8, 8]."""
    sub = lap_blocks[:, :, rows, cols]  # [nby, nbx, ys, xs]
    above = sub > threshold
    ys, xs = sub.shape[-2], sub.shape[-1]
    # Horizontal: runs along rows. A run starts where above & not above-prev.
    prev = jnp.pad(above, ((0, 0), (0, 0), (0, 0), (1, 0)))[..., :-1]
    h_cross = jnp.sum(jnp.logical_and(above, ~prev), axis=(-2, -1))
    avg_h = h_cross.astype(jnp.float32) / ys
    # Vertical: runs along columns.
    prevv = jnp.pad(above, ((0, 0), (0, 0), (1, 0), (0, 0)))[..., :-1, :]
    v_cross = jnp.sum(jnp.logical_and(above, ~prevv), axis=(-2, -1))
    avg_v = v_cross.astype(jnp.float32) / xs
    return jnp.floor(avg_h + avg_v)


def _colorfulness(x_blocks, b_blocks, rows: slice, cols: slice):
    """diff:107-151 over one sub-block geometry, all blocks at once."""
    xs_ = x_blocks[:, :, rows, cols]
    bs_ = b_blocks[:, :, rows, cols]
    mean_x = jnp.mean(xs_, axis=(-2, -1))
    mean_b = jnp.mean(bs_, axis=(-2, -1))
    var_x = jnp.mean((xs_ - mean_x[..., None, None]) ** 2, axis=(-2, -1))
    var_b = jnp.mean((bs_ - mean_b[..., None, None]) ** 2, axis=(-2, -1))
    return jnp.sqrt(var_x + var_b) + 0.3 * jnp.sqrt(mean_x**2 + mean_b**2)


def homogeneity_all_subblocks(xyb_planes: jnp.ndarray, distance: float) -> dict:
    """Homogeneity of every sub-block geometry for every 8x8 block.

    xyb_planes: [3, Hp, Wp] (padded to multiples of 8), channel order X,Y,B
    as in the codec. Returns dict geometry -> [nby, nbx] float32.
    """
    x_p, y_p, b_p = xyb_planes[0], xyb_planes[1], xyb_planes[2]
    t = laplacian_edge_threshold(distance)

    lap_b = _to_blocks(_laplacian_map(y_p))
    sml_b = _to_blocks(_sml_map(y_p))
    x_b = _to_blocks(x_p)
    b_b = _to_blocks(b_p)

    out = {}
    for name, (rows, cols) in _SUBBLOCKS.items():
        zc = _zero_crossings(lap_b, rows, cols, t)
        sml = jnp.sum(sml_b[:, :, rows, cols], axis=(-2, -1))
        col = _colorfulness(x_b, b_b, rows, cols)
        out[name] = zc + sml + col
    return out


def homogeneity_similarity_indices(xyb_planes: jnp.ndarray, distance: float):
    """r_h, r_v, r_d maps [nby, nbx] (diff:183-211, incl. the d1/d2
    precedence quirk)."""
    h = homogeneity_all_subblocks(xyb_planes, distance)
    r_h = jnp.maximum(h["h1"], h["h2"]) / jnp.minimum(h["h1"], h["h2"])
    r_v = jnp.maximum(h["v1"], h["v2"]) / jnp.minimum(h["v1"], h["v2"])
    # C++ args are (xsize, ysize, bx, by): d1 = H(0,0) + H(4,4)/2,
    # d2 = H(bx=0,by=4) + H(bx=4,by=0)/2. sic: only the second term of each
    # sum is halved (precedence in the C++, diff:200-203).
    d1 = h["q00"] + h["q11"] / 2.0
    d2 = h["q10"] + h["q01"] / 2.0
    r_d = jnp.maximum(d1, d2) / jnp.minimum(d1, d2)
    return r_h, r_v, r_d


def homogeneity_partition(r_h, r_v, r_d, distance: float) -> jnp.ndarray:
    """Strategy id per block (diff:226-234). NaN ratios (0/0 homogeneity)
    compare False against the threshold, keeping DCT — same as C++ NaN."""
    t = partition_threshold(distance)
    out = jnp.full(r_h.shape, ACS_DCT, jnp.int32)
    pick_84 = jnp.logical_and(r_h > r_v, r_h > t)
    pick_48 = jnp.logical_and(r_v > r_h, r_v > t)
    out = jnp.where(pick_84, ACS_DCT8X4, out)
    out = jnp.where(pick_48, ACS_DCT4X8, out)
    out = jnp.where(r_d > t, ACS_DCT4X4, out)  # r_d wins (first branch in C++)
    return out


def hook_b_factor(r_h, r_v, r_d) -> jnp.ndarray:
    """RD-cost multiplier of the factored-entropy variant:
    0.8 * avg(r_h, r_v, r_d) (homogeneity-factored-entropy.diff:248-254).
    NaN-safe: degenerate blocks fall back to factor 1."""
    avg = (r_h + r_v + r_d) / 3.0
    f = 0.8 * avg
    return jnp.where(jnp.isfinite(f), f, 1.0)
