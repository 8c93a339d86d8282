"""EPF tests: smoothing behavior + header signaling round-trip."""

import jax.numpy as jnp
import numpy as np

from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.container import read_container_header
from jxl_jax.codec.decode import decode_bytes
from jxl_jax.codec.encode import encode_image
from jxl_jax.metrics import calculate_psnr
from jxl_jax.transforms.epf import epf_apply
from tests.conftest import make_test_image


def test_epf_smooths_small_noise_keeps_edges():
    rng = np.random.default_rng(0)
    base = np.zeros((32, 32), np.float32)
    base[:, 16:] = 0.5  # hard edge
    noisy = base + rng.normal(0, 0.002, base.shape).astype(np.float32)
    planes = jnp.stack([noisy * 0.01, noisy, noisy * 0.5])
    eff = jnp.ones((4, 4), jnp.float32)
    out = np.asarray(epf_apply(planes, eff, 2.0))
    # noise reduced on the flat part
    flat_in = noisy[:, :12] - base[:, :12]
    flat_out = out[1][:, :12] - base[:, :12]
    assert flat_out.std() < flat_in.std()
    # edge magnitude preserved within 10%
    edge_in = noisy[:, 16].mean() - noisy[:, 15].mean()
    edge_out = out[1][:, 16].mean() - out[1][:, 15].mean()
    assert abs(edge_out) > 0.9 * abs(edge_in)


def test_epf_flag_roundtrip(monkeypatch):
    # pin the encoder's adaptive per-image EPF decision so the flag is
    # deterministic (the v8 encoder measures whether EPF helps and may
    # legitimately turn it off for this content)
    monkeypatch.setenv("JXL_JAX_EPF_FORCE", "1")
    img = make_test_image(48, 48, seed=2)
    d_on = encode_image(img, CodecConfig(distance=3.0, effort=3, epf=True))
    d_off = encode_image(img, CodecConfig(distance=3.0, effort=3, epf=False))
    assert read_container_header(d_on).epf is True
    assert read_container_header(d_off).epf is False
    out_on = decode_bytes(d_on)
    out_off = decode_bytes(d_off)
    assert not np.array_equal(out_on, out_off)  # filter actually ran
    # both stay in a sane quality range
    assert calculate_psnr(img, out_on) > 28
    assert calculate_psnr(img, out_off) > 28
