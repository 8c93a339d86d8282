"""Transport-layer regressions (round 4b): dense upload packing, the
history-adaptive encode fetch window (hit + miss paths), and the async
grid-row pipeline. These guard the host<->device formats that the wall
throughput depends on — byte-level bugs here corrupt streams silently.
"""

import numpy as np
import pytest

from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.decode import (
    _pack_stream_np,
    _pow2_bucket,
    _unpack_sections,
    decode_bytes,
)
from jxl_jax.codec.encode import (
    _NEED_HISTORY,
    _dist_key,
    _need_u32,
    _window_from_history,
    encode_image,
    encode_image_grid,
    encode_image_grid_async,
)


def _img(seed=0, h=96, w=128, flat=False):
    rng = np.random.default_rng(seed)
    if flat:
        return np.tile(
            np.linspace(0, 255, w, dtype=np.uint8)[None, :, None], (h, 1, 3)
        )
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.3 * np.sin(xx / 13.0) * np.cos(yy / 9.0)
    noise = rng.normal(0, 0.08, (h, w, 3)).astype(np.float32)
    rgb = np.clip(base[..., None] + noise, 0, 1)
    return (rgb * 255).astype(np.uint8)


def test_dense_pack_unpack_roundtrip():
    """_unpack_sections must exactly invert _pack_stream_np's dense
    word/mantissa packing (bitcast byte order is load-bearing)."""
    from jxl_jax.codec.container import read_container
    from jxl_jax.entropy.grouped import GROUP, MANT_SLACK, WORD_SLACK

    img = _img(3)
    data = encode_image(img, CodecConfig(distance=1.0, effort=5))
    s = read_container(data)
    capw = _pow2_bucket(int(s.wcounts.max()) + WORD_SLACK)
    capm = _pow2_bucket(int(s.mcounts.max()) + MANT_SLACK)
    packed = _pack_stream_np(s, capw, capm)
    states, wg, mg = (
        np.asarray(x)
        for x in _unpack_sections(
            packed, s.header.n_ctx, s.header.lanes, capw, capm
        )
    )
    assert np.array_equal(states, s.states)
    words = np.frombuffer(s.stream_words, dtype="<u2")
    mant = np.frombuffer(s.mant_bytes, dtype=np.uint8)
    G = s.header.lanes // GROUP
    wb = np.concatenate([[0], np.cumsum(s.wcounts.astype(np.int64))])
    mb = np.concatenate([[0], np.cumsum(s.mcounts.astype(np.int64))])
    for g in range(G):
        assert np.array_equal(wg[g, : s.wcounts[g]], words[wb[g] : wb[g + 1]])
        assert np.array_equal(mg[g, : s.mcounts[g]], mant[mb[g] : mb[g + 1]])
        assert not wg[g, s.wcounts[g] :].any()
        assert not mg[g, s.mcounts[g] :].any()


def test_fetch_window_hit_and_miss_bytes_identical():
    """A tight history window (hit) and an underestimating one (miss ->
    tail fetch) must both produce byte-identical containers to the
    cold-history encode."""
    cfg = CodecConfig(distance=1.0, effort=5)
    flat, busy = _img(flat=True), _img(7)

    _NEED_HISTORY.clear()
    cold_busy = encode_image(busy, cfg)
    _NEED_HISTORY.clear()
    # flat first: records a SMALL need for this (size, distance) bucket
    encode_image(flat, cfg)
    key = (flat.shape[0], flat.shape[1], None, None)  # shape-keyed entries exist
    assert any(k[:2] == key[:2] for k in _NEED_HISTORY)
    # busy second: the window from the flat image underestimates -> the
    # tail-fetch path runs; output must not change
    miss_busy = encode_image(busy, cfg)
    assert miss_busy == cold_busy
    # third time the history covers it: window hit; still identical
    hit_busy = encode_image(busy, cfg)
    assert hit_busy == cold_busy
    assert decode_bytes(hit_busy).shape == busy.shape


def test_window_sizing_properties():
    _NEED_HISTORY.clear()
    assert _window_from_history(128, 96, 128, [1.0]) is None
    _NEED_HISTORY[(96, 128, 128, _dist_key(1.0), "var")] = 10000
    w = _window_from_history(128, 96, 128, [1.0])
    assert w % 8192 == 0 and w >= int(10000 * 1.3)
    # any unobserved distance bucket in the batch disables the window
    assert _window_from_history(128, 96, 128, [1.0, 4.0]) is None


def test_batched_images_byte_identical_to_single():
    """encode_images_batched_async (one dispatch for N same-geometry
    images) must reproduce per-image encode_image containers exactly."""
    from jxl_jax.codec.encode import encode_images_batched_async

    cfg = CodecConfig(distance=1.2, effort=5)
    imgs = [_img(s) for s in (1, 2, 3)]
    singles = [encode_image(im, cfg) for im in imgs]
    batched = encode_images_batched_async(imgs, cfg)()
    assert batched == singles


def test_async_grid_matches_sync_and_pipelines():
    """Two overlapped async rows must equal back-to-back sync rows."""
    img = _img(11)
    cfg = CodecConfig(effort=5)
    ds = [0.8, 1.5, 3.0]
    sync = encode_image_grid(img, cfg, ds)
    f1 = encode_image_grid_async(img, cfg, ds)
    f2 = encode_image_grid_async(img, cfg, ds)  # dispatched before f1()
    assert f1() == sync
    assert f2() == sync
    for d, blob in zip(ds, sync):
        out = decode_bytes(blob)
        assert out.shape == img.shape
