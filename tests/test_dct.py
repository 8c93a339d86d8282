import jax.numpy as jnp
import numpy as np

from jxl_jax.transforms.dct import (
    dct2d,
    dct_matrix,
    idct2d,
    inverse_zigzag_order,
    zigzag_order,
)


def test_dct_matrix_orthonormal():
    for n in (4, 8, 16, 32):
        d = np.asarray(dct_matrix(n))
        np.testing.assert_allclose(d @ d.T, np.eye(n), atol=1e-5)


def test_dct2d_roundtrip():
    rng = np.random.default_rng(1)
    for shape in [(5, 8, 8), (3, 4, 8), (2, 16, 16), (7, 4, 4)]:
        x = rng.normal(size=shape).astype(np.float32)
        back = np.asarray(idct2d(dct2d(jnp.asarray(x))))
        np.testing.assert_allclose(back, x, atol=1e-4)


def test_dct_dc_is_mean():
    x = jnp.full((1, 8, 8), 3.0)
    c = np.asarray(dct2d(x))
    # orthonormal: DC = mean * sqrt(n*m) = 3 * 8
    np.testing.assert_allclose(c[0, 0, 0], 24.0, atol=1e-4)
    assert np.max(np.abs(c.ravel()[1:])) < 1e-4


def test_zigzag_is_permutation():
    for n, m in [(8, 8), (4, 4), (8, 4), (4, 8), (16, 16)]:
        zz = zigzag_order(n, m)
        assert sorted(zz.tolist()) == list(range(n * m))
        inv = inverse_zigzag_order(n, m)
        np.testing.assert_array_equal(inv[zz], np.arange(n * m))


def test_zigzag_8x8_starts_canonical():
    zz = zigzag_order(8, 8)
    # canonical JPEG zigzag prefix: 0, 1, 8, 16, 9, 2, 3, 10
    assert zz[0] == 0
    assert set(zz[1:3].tolist()) == {1, 8}
    assert set(zz[3:6].tolist()) == {2, 9, 16}
