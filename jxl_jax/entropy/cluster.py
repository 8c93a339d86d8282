"""Per-image histogram clustering (libjxl-style "clustered context models").

libjxl clusters per-context ANS histograms before signaling them (a greedy
agglomerative merge that trades payload entropy against header bytes); the
reference consumes this through cjxl (`docker_manager.rs:100-136`). This is
the equivalent here: a fixed-trip-count greedy merge that runs ON
DEVICE inside the fused encoder jit (no host round-trip), producing an EXPANDED [C, A] count matrix whose rows are
identical within a cluster. Downstream quantization then yields identical
freq-table rows, which the host container writer deduplicates into
`n_clusters` signaled tables + a [C] cluster map (container v6).

Merge criterion per step: join the pair (i, j) with the smallest payload
cost increase  dH = H(c_i + c_j) - H(c_i) - H(c_j)  (H = Shannon bits to
code the counts with their own table), and merge only while dH is smaller
than the header bytes the merge saves (sparse-table size model of
`container._pack_freq_tables`: 2 + 3*nnz bytes/table). The loop therefore
strictly reduces the total file-size estimate; contexts with disjoint
alphabets or genuinely different statistics stay separate.

Everything is masked/fixed-shape (fori_loop over C-1 potential merges) so
the pass is jit- and vmap-compatible (the RD-grid encoder vmaps it over
distances).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _entropy_bits(c: jnp.ndarray) -> jnp.ndarray:
    """[..., A] counts -> [...] total bits to code them with an ideal
    dedicated table (n*log2(n) - sum n_s*log2(n_s))."""
    cf = c.astype(jnp.float32)
    n = jnp.sum(cf, axis=-1)
    return n * jnp.log2(jnp.maximum(n, 1.0)) - jnp.sum(
        cf * jnp.log2(jnp.maximum(cf, 1.0)), axis=-1
    )


def cluster_histograms(counts: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Greedily merge context histograms while the merge shrinks the file.

    counts: [C, A] int32 per-context symbol counts.
    Returns (expanded [C, A] int32 — row c holds its CLUSTER's merged
    counts, identical across members — and cmap [C] int32 cluster
    representative ids, for tests/diagnostics).
    """
    C, A = counts.shape
    cf = counts.astype(jnp.float32)
    iota = jnp.arange(C, dtype=jnp.int32)

    def body(_, state):
        c, alive, cmap = state
        h = _entropy_bits(c)  # [C]
        pair = c[:, None, :] + c[None, :, :]  # [C, C, A]
        d_h = _entropy_bits(pair) - h[:, None] - h[None, :]
        # Header bytes saved by writing one merged sparse table instead of
        # two: ~2 + 3*|overlap| (shared symbols are stored once).
        nz_i = c > 0.0
        overlap = jnp.sum(
            (nz_i[:, None, :] & nz_i[None, :, :]).astype(jnp.float32), axis=-1
        )
        saving = 8.0 * (2.0 + 3.0 * overlap)
        valid = (
            alive[:, None]
            & alive[None, :]
            & (iota[:, None] < iota[None, :])
        )
        score = jnp.where(valid, d_h - saving, jnp.inf)
        flat = jnp.argmin(score)
        bi, bj = flat // C, flat % C
        do = score.reshape(-1)[flat] < 0.0
        merged_i = c[bi] + c[bj]
        c = jnp.where(
            do,
            c.at[bi].set(merged_i).at[bj].set(jnp.zeros((A,), jnp.float32)),
            c,
        )
        alive = jnp.where(do, alive.at[bj].set(False), alive)
        cmap = jnp.where(do & (cmap == bj), bi, cmap)
        return c, alive, cmap

    init = (cf, jnp.ones((C,), bool), iota)
    c, _alive, cmap = jax.lax.fori_loop(0, C - 1, body, init)
    expanded = jnp.round(c[cmap]).astype(jnp.int32)
    return expanded, cmap


def _structural_groups(C: int, k: int):
    """[C] static initial group ids for the v8 context set: the 9 non-AC
    contexts individually, AC contexts by (bucket, channel, coarse band).
    Falls back to id % k for non-v8 context counts."""
    import numpy as np

    from jxl_jax.codec.layout import CTX_AC_BASE, N_CTX, NNZ_Q

    if C != N_CTX or k < CTX_AC_BASE + 3 * 3 * NNZ_Q:
        return (np.arange(C) % k).astype(np.int32)
    g = np.zeros(C, np.int32)
    g[:CTX_AC_BASE] = np.arange(CTX_AC_BASE)
    pos = np.arange(3 * 63 * NNZ_Q)  # (q * 3 + c) * 63 + (p - 1)
    p1 = pos % 63 + 1  # zigzag position 1..63
    qc = pos // 63  # q * 3 + c
    band4 = (p1 >= 2).astype(np.int32) + (p1 >= 8) + (p1 >= 32)
    g[CTX_AC_BASE:] = CTX_AC_BASE + qc * 4 + band4
    return g


def _merge_rounds(c, k: int, rounds: int = 5):
    """Vectorized agglomerative merge: per round every live cluster
    proposes its best (lowest dH - header_saving) partner, and MUTUAL
    negative-score pairs merge simultaneously — up to k/2 merges per
    round instead of one per iteration, so 5 rounds replace the strictly
    sequential k-1-step greedy (which cost ~0.5 ms of serial [k, k, A]
    scans inside the fused encoder). Returns (counts, cmap [k])."""
    iota = jnp.arange(k, dtype=jnp.int32)

    def body(_, state):
        c, alive, cmap = state
        h = _entropy_bits(c)
        pair = c[:, None, :] + c[None, :, :]
        d_h = _entropy_bits(pair) - h[:, None] - h[None, :]
        nz = c > 0.0
        overlap = jnp.sum(
            (nz[:, None, :] & nz[None, :, :]).astype(jnp.float32), axis=-1
        )
        saving = 8.0 * (2.0 + 3.0 * overlap)
        valid = alive[:, None] & alive[None, :] & (iota[:, None] != iota[None, :])
        score = jnp.where(valid, d_h - saving, jnp.inf)
        best_j = jnp.argmin(score, axis=1).astype(jnp.int32)
        best_s = jnp.min(score, axis=1)
        mutual = (best_j[best_j] == iota) & (best_s < 0.0) & alive
        absorb = mutual & (iota > best_j)  # higher index folds into lower
        gain = mutual & (iota < best_j)
        c = c + jnp.where(gain[:, None], c[best_j], 0.0)
        c = jnp.where(absorb[:, None], 0.0, c)
        alive = alive & ~absorb
        rep = jnp.where(absorb, best_j, iota)
        return c, alive, rep[cmap]

    init = (c, jnp.ones((k,), bool), iota)
    c, _alive, cmap = jax.lax.fori_loop(0, rounds, body, init)
    return c, cmap


def cluster_histograms_kmeans(
    counts: jnp.ndarray, k: int = 64, iters: int = 6
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two-stage clustering for LARGE context counts (container v8's 765
    position x bucket AC contexts): the greedy pairwise merge above is
    O(C^3 A) — prohibitive at C=765 — so this first runs a Lloyd k-means
    on the cross-entropy objective (assignment and center updates are both
    matmuls), then hands the <= k cluster centers to the header-aware
    greedy merge, which keeps merging while the merge shrinks the file.

    Returns (cmap [C] int32 cluster ids in [0, k), ctables [k, A] int32
    merged counts — rows of dead clusters are zero). Correctness note:
    center updates are one-hot matmuls in f32 HIGHEST, so any symbol that
    occurs in a member context has a strictly positive center count, which
    quantize_histograms_t turns into freq >= 1 — the rANS validity
    requirement.
    """
    C, A = counts.shape
    cf = counts.astype(jnp.float32)
    totals = jnp.sum(cf, axis=1)

    def assign_cost(centers):
        p = centers / jnp.maximum(jnp.sum(centers, axis=1, keepdims=True), 1.0)
        logp = jnp.log2(jnp.maximum(p, 1e-8))
        # cost[i, j] = sum_a counts[i, a] * -log2 p_j[a]
        return -jnp.dot(
            cf, logp.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    # Deterministic STRUCTURAL init: one center per static context group
    # (the 9 non-AC contexts individually + AC grouped by bucket x channel
    # x 4 coarse bands = 57 groups). Picking the k HEAVIEST contexts fails
    # badly here — v8's context set contains hundreds of near-identical
    # pure-zero histograms whose totals dominate, so top-k centers
    # collapse and Lloyd never recovers (empty centers price everything
    # at the log-floor and stay empty). The structural grouping seeds one
    # center per statistically-distinct stripe with a single static-one-
    # hot matmul (no sequential farthest-point loop — it cost ~0.3 ms of
    # strictly serial matvecs inside the fused encoder).
    ginit = jnp.asarray(_structural_groups(C, k))
    goh = (ginit[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    centers = jnp.dot(
        goh.T, cf, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )

    def body(_, centers):
        assign = jnp.argmin(assign_cost(centers), axis=1)
        oh = (assign[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
        return jnp.dot(
            oh.T, cf, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    centers = jax.lax.fori_loop(0, iters, body, centers)
    assign = jnp.argmin(assign_cost(centers), axis=1)
    oh = (assign[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    centers = jnp.dot(
        oh.T, cf, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    import os

    if os.environ.get("JXL_JAX_CLUSTER_NO_GREEDY"):  # diagnostic A/B knob
        return assign.astype(jnp.int32), jnp.round(centers).astype(jnp.int32)
    # header-aware vectorized merge over the k centers
    merged, inner_map = _merge_rounds(centers, k)
    cmap = inner_map[assign]
    return cmap.astype(jnp.int32), jnp.round(merged).astype(jnp.int32)
