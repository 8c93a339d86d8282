"""Image file I/O.

Replaces the reference's `image` crate + jpegxl-rs decode path
(`benchmark-jpegxl/src/image_reader.rs:317-439`): reads any PIL-supported
format (PNG/PPM/JPEG/... — covers the reference's 16-format enum) into numpy
RGB u8, and reads/writes this framework's own `.jxt` bitstream via the codec.

PNG (8-bit gray / gray+alpha / RGB / RGBA, non-interlaced) and PPM/PGM are
read and written with numpy + the standard library's zlib, so the codec
and the sweep run where PIL is not installed; PIL serves the other
formats.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from jxl_jax.core.image import ColorType, ImageFileData, ImageFormat, format_from_path

try:
    from PIL import Image as _PILImage

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


def _read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    parts = []
    idx = 0
    # parse header tokens, skipping comments
    while len(parts) < 4:
        nl = data.find(b"\n", idx)
        line = data[idx : nl if nl != -1 else len(data)]
        idx = nl + 1
        line = line.split(b"#")[0]
        parts.extend(line.split())
    magic, w, h, maxval = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    raw = np.frombuffer(data[idx:], dtype=np.uint8)
    if magic == b"P6":
        return raw[: w * h * 3].reshape(h, w, 3)
    if magic == b"P5":
        g = raw[: w * h].reshape(h, w)
        return np.stack([g, g, g], axis=-1)
    raise ValueError(f"unsupported PNM magic {magic!r}")


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def _unfilter_rows(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo None/Sub/Up filters (RFC 2083 §6) row by row, each row one
    vector operation; uint8 arithmetic wraps as the filters do."""
    px = np.empty_like(filt)
    prev = np.zeros(filt.shape[1], np.uint8)
    for y, f in enumerate(ftype.tolist()):
        row = filt[y]
        if f == 1:  # Sub: a running sum along each byte position of a pixel
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            row = row + prev
        prev = px[y] = row
    return px


def _unfilter_wavefront(filt: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo any mix of the five PNG filters. Average and Paeth read the
    reconstructed left, upper and upper-left pixels, so pixel (r, c) waits
    for (r, c-1), (r-1, c) and (r-1, c-1): all pixels of one anti-diagonal
    r + c = k are independent and are reconstructed together, h + w - 1
    vector steps in all instead of one Python step per byte."""
    h = filt.shape[0]
    w = filt.shape[1] // bpp
    nk = h + w - 1
    # skew[r + c, r] = filt[r, c]: rows written with a stride one pixel
    # longer than the row, so row r starts r pixels further right
    z = np.zeros((h, nk + 1, bpp), np.int16)
    np.lib.stride_tricks.as_strided(
        z, (h, w, bpp), (z.strides[0] + z.strides[1], z.strides[1], z.strides[2]),
        writeable=True,
    )[:] = filt.reshape(h, w, bpp)
    skew = np.ascontiguousarray(z[:, :nk].transpose(1, 0, 2))
    # out[k + 2, r + 1] = pixel (r, k - r): two zero diagonals before k = 0
    # and a zero row before r = 0 give the filters' zero borders
    out = np.zeros((nk + 2, h + 1, bpp), np.int16)
    kinds = {f: (ftype == f)[:, None] for f in (1, 2, 3, 4) if (ftype == f).any()}
    for k in range(nk):
        r0, r1 = max(0, k - w + 1), min(h, k + 1)
        a = out[k + 1, r0 + 1 : r1 + 1]  # left
        b = out[k + 1, r0:r1]  # up
        pred = np.zeros_like(a)
        for f, rows in kinds.items():
            if f == 1:
                p = a
            elif f == 2:
                p = b
            elif f == 3:
                p = (a + b) >> 1
            else:
                c = out[k, r0:r1]  # upper left
                pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
                p = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = np.where(rows[r0:r1], p, pred)
        out[k + 2, r0 + 1 : r1 + 1] = (skew[k, r0:r1] + pred) & 255
    o = np.ascontiguousarray(out.transpose(1, 0, 2))[1:, 2:]  # [r, r + c]
    px = np.lib.stride_tricks.as_strided(
        o, (h, w, bpp), (o.strides[0] + o.strides[1], o.strides[1], o.strides[2])
    )
    return px.astype(np.uint8).reshape(h, w * bpp)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to RGB uint8 [H, W, 3] (alpha is
    dropped, gray is replicated)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat = 8, []
    w = h = depth = ctype = interlace = None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if w is None or depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray/RGB/RGBA PNG is supported "
            f"(bit depth {depth}, color type {ctype}, interlace {interlace})"
        )
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is shorter than {h} rows")
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    ftype, filt = raw[:, 0], raw[:, 1:]
    if h and ftype.max() > 4:
        raise ValueError(f"{path}: PNG filter type {int(ftype.max())} (0..4 exist)")
    if h and ftype.max() > 2:  # Average or Paeth rows present
        px = _unfilter_wavefront(filt, ftype, bpp)
    else:
        px = _unfilter_rows(filt, ftype, bpp)
    px = px.reshape(h, w, bpp)
    if bpp <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def write_png(path: str, rgb: np.ndarray) -> None:
    """Encode RGB uint8 [H, W, 3] as an 8-bit PNG (filter type 0 rows)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
        )

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """Read an image file to RGB uint8 [H, W, 3]."""
    fmt = format_from_path(path)
    if fmt == ImageFormat.Jxt:
        from jxl_jax.codec.decode import decode_file

        return decode_file(path)
    if fmt == ImageFormat.Png:
        return read_png(path)
    if fmt == ImageFormat.Pnm or not _HAVE_PIL:
        return _read_ppm(path)
    img = _PILImage.open(path).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def write_image(path: str, rgb: np.ndarray) -> None:
    """Write RGB uint8 [H, W, 3] to a file (format from extension; PPM
    for formats other than PNG when PIL is absent)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    fmt = format_from_path(path)
    if fmt == ImageFormat.Png:
        write_png(path, rgb)
    elif fmt == ImageFormat.Pnm or not _HAVE_PIL:
        _write_ppm(path, rgb)
    else:
        _PILImage.fromarray(rgb, mode="RGB").save(path)


def read_image_metadata(path: str, test_set: str = "", commit: str = "") -> ImageFileData:
    """Build the 13-column metadata record for a file.

    For `.jxt` files, distance/effort/original-name come from the container
    header (the reference instead re-parses them from the filename,
    `image_reader.rs:385-411`).
    """
    fmt = format_from_path(path)
    file_size = os.path.getsize(path)
    name = os.path.basename(path)
    if fmt == ImageFormat.Jxt:
        from jxl_jax.codec.container import read_header

        hdr = read_header(path)
        return ImageFileData(
            image_name=name,
            commit=commit or hdr.strategy_name,
            test_set=test_set,
            file_path=path,
            width=hdr.width,
            height=hdr.height,
            file_size=file_size,
            raw_size=hdr.width * hdr.height * 3,
            color_space=ColorType.Rgb8,
            format=fmt,
            jxl_orig_image_name=hdr.orig_name,
            jxl_distance=hdr.distance,
            jxl_effort=hdr.effort,
        )
    rgb = read_image(path)
    h, w = rgb.shape[:2]
    return ImageFileData(
        image_name=name,
        commit=commit,
        test_set=test_set,
        file_path=path,
        width=w,
        height=h,
        file_size=file_size,
        raw_size=w * h * 3,
        color_space=ColorType.Rgb8,
        format=fmt,
    )
