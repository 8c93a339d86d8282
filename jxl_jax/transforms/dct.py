"""Orthonormal DCT-II transforms as batched matmuls.

The reference's DCT lives inside libjxl's C++ (variable-size DCT 8x8..256x256
of the VarDCT mode, invoked via `cjxl`, `docker_manager.rs:100-136`). Here
every block size is a pair of small dense matrix multiplies, so a batch of
blocks is one batched matmul:  C = D_n @ X @ D_m^T  for an n x m block,
batched over thousands of blocks per group.

Orthonormal DCT-II:  D[k, j] = c_k * cos(pi * (j + 0.5) * k / n),
c_0 = sqrt(1/n), c_k = sqrt(2/n).  D is orthogonal: D @ D.T = I, so the
inverse transform is the transpose — no separate IDCT tables.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def _dct_matrix_np(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    mat = np.cos(np.pi * (j + 0.5) * k / n)
    mat *= np.sqrt(2.0 / n)
    mat[0] *= np.sqrt(0.5)
    return mat.astype(np.float32)


def dct_matrix(n: int) -> jnp.ndarray:
    """[n, n] orthonormal DCT-II matrix."""
    return jnp.asarray(_dct_matrix_np(n))


# Precision.HIGHEST: at default precision the GPU may run f32 matmuls in
# TF32 (~1e-3 relative error) — fine for neural nets, not for a transform
# whose output is quantized with ~1e-3 steps. HIGHEST keeps full f32.
_PREC = jax.lax.Precision.HIGHEST


def dct2d(blocks: jnp.ndarray) -> jnp.ndarray:
    """2D DCT over the last two dims: [..., n, m] -> [..., n, m]."""
    n, m = blocks.shape[-2], blocks.shape[-1]
    dn, dm = dct_matrix(n), dct_matrix(m)
    out = jnp.einsum(
        "ij,...jk,lk->...il",
        dn,
        blocks,
        dm,
        preferred_element_type=jnp.float32,
        precision=_PREC,
    )
    return out


def idct2d(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Inverse 2D DCT over the last two dims (transpose of dct2d)."""
    n, m = coeffs.shape[-2], coeffs.shape[-1]
    dn, dm = dct_matrix(n), dct_matrix(m)
    return jnp.einsum(
        "ji,...jk,kl->...il",
        dn,
        coeffs,
        dm,
        preferred_element_type=jnp.float32,
        precision=_PREC,
    )


@lru_cache(maxsize=None)
def zigzag_order(n: int, m: int) -> np.ndarray:
    """Flat indices of an n x m coefficient block in zigzag (low->high freq) order.

    Generalized JPEG zigzag: sort by diagonal (u+v), alternating direction.
    Returns int32 array of length n*m with flat indices into the row-major block.
    """
    coords = [(u, v) for u in range(n) for v in range(m)]
    coords.sort(key=lambda uv: (uv[0] + uv[1], uv[1] if (uv[0] + uv[1]) % 2 == 0 else uv[0]))
    return np.array([u * m + v for u, v in coords], dtype=np.int32)


@lru_cache(maxsize=None)
def _perm_matrix_np(perm: tuple) -> np.ndarray:
    n = len(perm)
    p = np.zeros((n, n), np.float32)
    p[np.arange(n), list(perm)] = 1.0
    return p


def permute_last(x: jnp.ndarray, perm: np.ndarray) -> jnp.ndarray:
    """out[..., i] = x[..., perm[i]] via a one-hot matmul.

    A small permutation matmul fuses where a gather over a large array
    would not, so fancy-indexing with a fixed permutation (zigzag et al.)
    is written as one. Exact for
    integer payloads < 2^24 (f32 one-hot dot at HIGHEST precision).
    """
    p = jnp.asarray(_perm_matrix_np(tuple(int(v) for v in perm)))
    dtype = x.dtype
    out = jnp.einsum(
        "...j,ij->...i",
        x.astype(jnp.float32),
        p,
        precision=_PREC,
        preferred_element_type=jnp.float32,
    )
    if jnp.issubdtype(dtype, jnp.integer):
        return jnp.round(out).astype(dtype)
    return out.astype(dtype)


def select_rows(idx: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """out[k, :] = table[idx[k], :] via one-hot matmul (idx: [K] int, table:
    [V, D]) — the matmul replacement for vocabulary-style gathers."""
    v = table.shape[0]
    onehot = (idx[:, None] == jnp.arange(v)[None, :]).astype(jnp.float32)
    return jnp.einsum(
        "kv,vd->kd",
        onehot,
        table.astype(jnp.float32),
        precision=_PREC,
        preferred_element_type=jnp.float32,
    )


@lru_cache(maxsize=None)
def inverse_zigzag_order(n: int, m: int) -> np.ndarray:
    """Permutation inverse of zigzag_order: position of each flat index."""
    zz = zigzag_order(n, m)
    inv = np.empty_like(zz)
    inv[zz] = np.arange(n * m, dtype=np.int32)
    return inv
