"""Histogram clustering (entropy/cluster.py + container v6).

The reference gets clustered context models from libjxl's ANS layer (via
cjxl, `docker_manager.rs:100-136`); these tests pin the on-device
equivalent: the on-device greedy merge, the v6 container's deduplicated
tables, and the invariant that clustering changes ONLY the signaled tables
(and through them the rANS stream) — never the decoded pixels.
"""

import numpy as np
import jax
import jax.numpy as jnp

from jxl_jax.entropy.cluster import cluster_histograms


def test_identical_rows_merge():
    row = np.zeros(38, np.int32)
    row[:4] = [500, 300, 150, 50]
    counts = np.stack([row, row, row, row])
    expanded, cmap = jax.jit(cluster_histograms)(jnp.asarray(counts))
    cmap = np.asarray(cmap)
    assert len(np.unique(cmap)) == 1
    np.testing.assert_array_equal(np.asarray(expanded)[0], row * 4)


def test_distinct_rows_stay_separate():
    # Two sharply different, well-populated distributions: merging them
    # costs far more payload entropy than one sparse table's header.
    a = np.zeros(38, np.int32)
    a[0] = 100_000
    b = np.zeros(38, np.int32)
    b[20:30] = 10_000
    expanded, cmap = jax.jit(cluster_histograms)(jnp.asarray(np.stack([a, b])))
    cmap = np.asarray(cmap)
    assert cmap[0] != cmap[1]
    np.testing.assert_array_equal(np.asarray(expanded), np.stack([a, b]))


def test_container_v6_round_trip_and_dedupe():
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.container import read_container
    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.codec.encode import encode_image

    rng = np.random.default_rng(7)
    base = rng.normal(130, 30, (48, 64, 1))
    img = np.clip(base + rng.normal(0, 6, (48, 64, 3)), 0, 255).astype(np.uint8)
    data = encode_image(jnp.asarray(img), CodecConfig(distance=1.0, effort=5))
    s = read_container(data)
    n_unique = len(np.unique(s.freq, axis=0))
    # the expanded freq keeps one row per static context...
    assert s.freq.shape[0] >= n_unique
    # ...but a flat-ish image must actually cluster (many empty contexts)
    assert n_unique < s.freq.shape[0]
    out = np.asarray(decode_bytes(data))
    assert out.shape == img.shape
    # lossy decode sanity: close to the source
    assert np.mean((out.astype(np.float32) - img.astype(np.float32)) ** 2) < 200.0
