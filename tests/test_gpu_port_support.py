"""Support code that the GPU build relies on, checked on the CPU: the
compilation-cache location, the numpy PNG codec (the card's machine has
no PIL), and the benchmark's peak-rate table."""

import os
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    import jax

    from jxl_jax.utils import jax_setup

    monkeypatch.delenv("JXL_JAX_NO_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_setup.cache_dir() == str(tmp_path)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    jax_setup.configure_jax()
    assert calls == []  # JAX reads the variable itself; nothing else is set


def test_cache_dir_fixed_path_in_checkout(monkeypatch):
    import jax

    from jxl_jax.utils import jax_setup

    monkeypatch.delenv("JXL_JAX_NO_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax_setup.cache_dir() == str(ROOT / ".jax_cache")
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    jax_setup.configure_jax()
    assert calls == [("jax_compilation_cache_dir", str(ROOT / ".jax_cache"))]
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
    monkeypatch.setenv("JXL_JAX_NO_CACHE", "1")
    assert jax_setup.cache_dir() is None


def test_png_roundtrip(tmp_path):
    from jxl_jax.core.io import read_image, write_image

    rgb = np.random.default_rng(0).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_image(p, rgb)
    np.testing.assert_array_equal(read_image(p), rgb)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_matches_pil(tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    from jxl_jax.core.io import read_png

    yy, xx = np.mgrid[0:41, 0:67]
    rgb = np.stack([xx * 3, yy * 5, (xx * yy) % 256], -1).astype(np.uint8)
    rgb[::7, ::5] = 255 - rgb[::7, ::5]  # break smoothness: all five filters
    im = Image.fromarray(rgb).convert(mode)
    p = str(tmp_path / f"x_{mode}.png")
    im.save(p)
    np.testing.assert_array_equal(read_png(p), np.asarray(im.convert("RGB")))


def test_png_writer_readable_by_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    from jxl_jax.core.io import write_png

    rgb = np.random.default_rng(1).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    p = str(tmp_path / "w.png")
    write_png(p, rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), rgb)


def _png_with_filters(path, px: np.ndarray, ftypes) -> None:
    """Write an 8-bit PNG whose row y is filtered with ftypes[y], by a
    plain per-byte implementation of RFC 2083 §6 (independent of the
    reader under test). px: [h, w, bpp] u8 (bpp 1, 3 or 4)."""
    import struct
    import zlib

    h, w, bpp = px.shape
    x = px.reshape(h, w * bpp).astype(int)
    rows = []
    for y in range(h):
        f = ftypes[y % len(ftypes)]
        out = [f]
        for i in range(w * bpp):
            a = x[y, i - bpp] if i >= bpp else 0
            b = x[y - 1, i] if y else 0
            c = x[y - 1, i - bpp] if y and i >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (
                b if abs(p - b) <= abs(p - c) else c
            )
            pred = [0, a, b, (a + b) // 2, paeth][f]
            out.append((x[y, i] - pred) & 255)
        rows.append(bytes(out))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ctype = {1: 0, 3: 2, 4: 6}[bpp]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("bpp", [1, 3, 4])
@pytest.mark.parametrize(
    "ftypes", [(1,), (2,), (3,), (4,), (0, 1, 2), (4, 3, 0, 2, 1)],
    ids=["sub", "up", "average", "paeth", "none-sub-up", "mixed"],
)
def test_png_reader_undoes_each_filter(tmp_path, ftypes, bpp):
    from jxl_jax.core.io import read_png

    rng = np.random.default_rng(len(ftypes) * 10 + bpp)
    yy, xx = np.mgrid[0:23, 0:31]
    px = (np.stack([xx * 7 + yy * 3] * bpp, -1) + rng.integers(0, 40, (23, 31, bpp))) % 256
    px = px.astype(np.uint8)
    p = str(tmp_path / "f.png")
    _png_with_filters(p, px, ftypes)
    want = np.repeat(px, 3, axis=2) if bpp == 1 else px[..., :3]
    np.testing.assert_array_equal(read_png(p), want)


def test_png_reader_rejects_unknown_filter_type(tmp_path):
    import struct
    import zlib

    from jxl_jax.core.io import read_png

    p = tmp_path / "f5.png"
    _png_with_filters(str(p), np.zeros((2, 3, 3), np.uint8), (0,))
    data = p.read_bytes()
    idat = zlib.compress(b"\x00" * 10 + b"\x05" + b"\x00" * 9)  # row 1: filter 5
    i = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[i : i + 4])[0]
    body = struct.pack(">I", len(idat)) + b"IDAT" + idat + struct.pack(">I", zlib.crc32(b"IDAT" + idat))
    p.write_bytes(data[:i] + body + data[i + 12 + n :])
    with pytest.raises(ValueError, match="filter type 5"):
        read_png(str(p))


def test_png_reader_rejects_16_bit(tmp_path):
    import struct
    import zlib

    from jxl_jax.core.io import read_png

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body)
        )

    p = tmp_path / "deep.png"
    p.write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 16, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(b"\x00" + b"\x00" * 6)) + chunk(b"IEND", b"")
    )
    with pytest.raises(ValueError, match="8-bit"):
        read_png(str(p))


def test_peak_table():
    sys.path.insert(0, str(ROOT))
    import bench

    assert bench.peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks_for("Unknown Accelerator 9000")


def test_bench_refuses_cpu():
    sys.path.insert(0, str(ROOT))
    import bench

    with pytest.raises(SystemExit, match="measures the GPU"):
        bench.main()
