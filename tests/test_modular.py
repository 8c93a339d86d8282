"""Modular-lossy mode: quantized-plane modular coding
for sharp synthetic content + the per-image VarDCT-vs-modular decision."""

import numpy as np
import pytest

from jxl_jax.codec import decode, encode
from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.container import read_container_header

from tests.conftest import make_test_image


def synth_graphics(h=96, w=128, seed=0):
    """Text/graphics-like content: flat fills, hard edges, a noise patch."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 230, np.uint8)
    img[10:30, 10:100] = [20, 30, 40]
    img[40:44, :] = 255
    img[:, 60:62] = 0
    img[60:90, 20:50] = rng.integers(0, 255, (30, 30, 3), dtype=np.uint8)
    return img


def test_modular_lossy_error_bound():
    """Reconstruction error is bounded by the quantizer geometry: each
    YCoCg plane is off by at most step/2 (+1 for the int lifting), so the
    worst RGB error is a small step-derived constant — no ringing."""
    from jxl_jax.codec.lossless import modular_steps

    img = synth_graphics()
    for d in (0.5, 1.0, 3.0):
        fin = encode._modular_async(img, CodecConfig(distance=d))
        data = fin()
        h = read_container_header(data)
        assert h.lossless and h.distance == d  # modular family flag
        out = np.asarray(decode.decode_bytes(data))
        sy, sco, scg = (int(x) for x in np.asarray(modular_steps(d)))
        bound = (sy + (scg + 1) // 2 + (sco + 1) // 2 + 2) // 2 + 2
        err = np.abs(out.astype(int) - img.astype(int)).max()
        assert err <= bound, (d, err, bound)


def test_modular_steps_identity_at_zero():
    from jxl_jax.codec.lossless import modular_steps

    assert np.asarray(modular_steps(0.0)).tolist() == [1, 1, 1]
    assert np.asarray(modular_steps(0.05)).tolist() == [1, 1, 1]


def test_decision_picks_modular_on_graphics():
    img = synth_graphics()
    assert encode._modular_candidate(img)
    data = encode.encode_image(img, CodecConfig(distance=1.0))
    h = read_container_header(data)
    assert h.lossless  # modular won the measured decision
    out = np.asarray(decode.decode_bytes(data))
    mse = np.mean((out.astype(np.float64) - img.astype(np.float64)) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 35.0


def test_decision_keeps_vardct_on_photo():
    img = make_test_image(96, 128, seed=9)
    assert not encode._modular_candidate(img)
    data = encode.encode_image(img, CodecConfig(distance=1.0))
    assert not read_container_header(data).lossless


def test_modular_grid_matches_single(monkeypatch):
    """The one-dispatch modular grid produces byte-identical containers to
    per-distance single encodes."""
    img = synth_graphics(seed=2)
    cfg = CodecConfig(distance=1.0)
    ds = [0.7, 1.4, 3.0]
    grid = encode._modular_grid_async(img, cfg, ds)()
    for d, g in zip(ds, grid):
        from dataclasses import replace

        single = encode._modular_async(img, replace(cfg, distance=d))()
        assert g == single


def test_grid_decision_per_point():
    """encode_image_grid picks the mode per distance on candidate images
    and every container round-trips."""
    img = synth_graphics(seed=3)
    datas = encode.encode_image_grid(img, CodecConfig(distance=1.0), [0.5, 2.0])
    for data in datas:
        out = np.asarray(decode.decode_bytes(data))
        assert out.shape == img.shape


def test_forced_off_env(monkeypatch):
    monkeypatch.setenv("JXL_JAX_MODULAR", "0")
    img = synth_graphics(seed=4)
    assert not encode._modular_candidate(img)
    data = encode.encode_image(img, CodecConfig(distance=1.0))
    assert not read_container_header(data).lossless
