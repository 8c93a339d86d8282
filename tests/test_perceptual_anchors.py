"""Perceptual metrics pinned to EXTERNAL anchors.

The reference consumes the real `butteraugli_main` / `ssimulacra2` tools
(`docker_manager.rs:148-175`, parsed at `metrics.rs:96-144`); this repo
reimplements their structures with re-fitted weights. These tests encode
the published tools' *behavioral contract* so that any weight drift fails:

- SSIMULACRA2's published score semantics (from its README / usage docs):
  >= 90 visually lossless, ~70 high quality, ~50 medium, <= 30 low.
- Butteraugli's unit convention: a cjxl `--distance D` encode of
  photographic content scores a max-distance around D.
- Rank concordance: across a mixed distortion ladder (noise, blur, codec
  artifacts at increasing strength) both metrics must order severity
  levels consistently within each family and agree with each other on the
  gross ordering (Kendall tau bound).

Residual error bounds vs the real tools are documented in PARITY.md.
"""

import numpy as np
import pytest

from bench import synth_kodak
from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.decode import decode_bytes
from jxl_jax.codec.encode import encode_image
from jxl_jax.metrics.perceptual import calculate_butteraugli, calculate_ssimulacra2


@pytest.fixture(scope="module")
def img():
    return synth_kodak(128, 160, seed=3)


@pytest.fixture(scope="module")
def ladder(img):
    """Mixed distortion ladder: (name, severity-rank-within-family, comp)."""
    from scipy import ndimage

    rng = np.random.default_rng(7)
    out = []
    for i, s in enumerate((2.0, 8.0, 25.0)):
        comp = np.clip(
            img.astype(np.float64) + rng.normal(0, s, img.shape), 0, 255
        ).astype(np.uint8)
        out.append((f"noise{s}", i, comp))
    for i, s in enumerate((0.8, 2.0, 4.0)):
        comp = np.clip(
            ndimage.gaussian_filter(img.astype(np.float64), (s, s, 0)), 0, 255
        ).astype(np.uint8)
        out.append((f"blur{s}", i, comp))
    for i, d in enumerate((1.0, 4.0, 12.0)):
        comp = decode_bytes(encode_image(img, CodecConfig(distance=d, effort=7)))
        out.append((f"codec{d}", i, comp))
    return out


def test_ssimulacra2_score_brackets(img):
    """Published SSIMULACRA2 quality anchors (>=90 visually lossless,
    ~70 high, ~50 medium, <=30 low) — brackets fail on weight drift."""
    rng = np.random.default_rng(0)

    tiny = np.clip(
        img.astype(np.float64) + rng.normal(0, 1.0, img.shape), 0, 255
    ).astype(np.uint8)
    assert calculate_ssimulacra2(img, tiny) >= 85.0

    d1 = decode_bytes(encode_image(img, CodecConfig(distance=1.0)))
    s_d1 = calculate_ssimulacra2(img, d1)
    assert 55.0 <= s_d1 <= 98.0  # "visually lossless-ish" operating point

    d8 = decode_bytes(encode_image(img, CodecConfig(distance=8.0)))
    s_d8 = calculate_ssimulacra2(img, d8)
    assert 5.0 <= s_d8 <= 70.0
    assert s_d8 < s_d1 - 5.0

    wrecked = np.clip(
        img.astype(np.float64) + rng.normal(0, 50, img.shape), 0, 255
    ).astype(np.uint8)
    assert calculate_ssimulacra2(img, wrecked) <= 40.0


def test_butteraugli_tracks_codec_distance(img):
    """cjxl-unit convention: a --distance D encode scores a max-distance
    in the same decade as D, monotone throughout. The coarse-scale bands
    (LF/LF2) plus the intensity-response nonlinearity keep the score
    growing at high distance: d=12 is pinned inside
    [6, 24] — within ~2x of its nominal unit."""
    prev = 0.0
    for d, lo, hi in ((0.5, 0.1, 3.0), (1.0, 0.5, 4.0), (4.0, 1.5, 9.0), (12.0, 6.0, 24.0)):
        comp = decode_bytes(encode_image(img, CodecConfig(distance=d, effort=7)))
        ba, p3 = calculate_butteraugli(img, comp)
        assert lo <= ba <= hi, (d, ba)
        assert ba > prev * 0.9  # monotone up to mild tolerance
        assert 0 < p3 <= ba + 1e-6  # 3-norm never exceeds the max-norm
        prev = ba


def _kendall_tau(a, b):
    n = len(a)
    num = 0
    tot = 0
    for i in range(n):
        for j in range(i + 1, n):
            sa, sb = np.sign(a[i] - a[j]), np.sign(b[i] - b[j])
            if sa and sb:
                tot += 1
                num += int(sa == sb)
    return num / max(tot, 1)


def test_rank_concordance_across_ladder(img, ladder):
    """Within each distortion family both metrics order severities
    strictly; across the full ladder the two metrics agree on gross
    ordering (Kendall tau >= 0.6 — the published tools track each other
    about this well on mixed content)."""
    bas, s2s, fams = [], [], {}
    for name, rank, comp in ladder:
        ba, _ = calculate_butteraugli(img, comp)
        s2 = calculate_ssimulacra2(img, comp)
        bas.append(ba)
        s2s.append(s2)
        fams.setdefault(name.rstrip("0123456789."), []).append((rank, ba, s2))
    for fam, rows in fams.items():
        rows.sort()
        ba_seq = [r[1] for r in rows]
        s2_seq = [r[2] for r in rows]
        assert ba_seq == sorted(ba_seq), (fam, ba_seq)
        assert s2_seq == sorted(s2_seq, reverse=True), (fam, s2_seq)
    tau = _kendall_tau(np.asarray(bas), -np.asarray(s2s))
    assert tau >= 0.6, tau
