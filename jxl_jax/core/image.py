"""Image metadata containers — parity with the reference's `ImageReader` layer.

Mirrors (API-level, not code-level) `benchmark-jpegxl/src/image_reader.rs`:
- `ColorType` (image_reader.rs:12-24): 10 variants L8..Rgba32F,
- `ImageFormat` (image_reader.rs:96-115): 16 formats + Unsupported,
- `ImageFileData` (image_reader.rs:285-300): per-file metadata record with
  raw size = W*H*bytes_per_pixel, JXL distance/effort fields that are empty
  for non-JXL files (the reference wraps these in JXLf32/JXLu32/JXLString,
  image_reader.rs:196-282; we use Optional instead).

Unlike the reference — which parses distance/effort back out of the
`name-<d>-<e>.jxl` filename (image_reader.rs:385-411, flagged fragile in
SURVEY §5.5) — our bitstream container stores the parameters in its header,
and this module reads them from there.
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field
from typing import Optional


class ColorType(enum.Enum):
    L8 = "L8"
    La8 = "La8"
    Rgb8 = "Rgb8"
    Rgba8 = "Rgba8"
    L16 = "L16"
    La16 = "La16"
    Rgb16 = "Rgb16"
    Rgba16 = "Rgba16"
    Rgb32F = "Rgb32F"
    Rgba32F = "Rgba32F"
    Unsupported = "Unsupported"

    @property
    def bytes_per_pixel(self) -> int:
        return {
            ColorType.L8: 1,
            ColorType.La8: 2,
            ColorType.Rgb8: 3,
            ColorType.Rgba8: 4,
            ColorType.L16: 2,
            ColorType.La16: 4,
            ColorType.Rgb16: 6,
            ColorType.Rgba16: 8,
            ColorType.Rgb32F: 12,
            ColorType.Rgba32F: 16,
            ColorType.Unsupported: 0,
        }[self]

    @property
    def channels(self) -> int:
        return {
            ColorType.L8: 1,
            ColorType.La8: 2,
            ColorType.Rgb8: 3,
            ColorType.Rgba8: 4,
            ColorType.L16: 1,
            ColorType.La16: 2,
            ColorType.Rgb16: 3,
            ColorType.Rgba16: 4,
            ColorType.Rgb32F: 3,
            ColorType.Rgba32F: 4,
            ColorType.Unsupported: 0,
        }[self]


class ImageFormat(enum.Enum):
    Png = "Png"
    Jpeg = "Jpeg"
    Gif = "Gif"
    WebP = "WebP"
    Pnm = "Pnm"
    Tiff = "Tiff"
    Tga = "Tga"
    Dds = "Dds"
    Bmp = "Bmp"
    Ico = "Ico"
    Hdr = "Hdr"
    OpenExr = "OpenExr"
    Farbfeld = "Farbfeld"
    Avif = "Avif"
    Qoi = "Qoi"
    Jxl = "Jxl"
    Jxt = "Jxt"  # this framework's own bitstream container
    Unsupported = "Unsupported"


_EXT_TO_FORMAT = {
    ".png": ImageFormat.Png,
    ".jpg": ImageFormat.Jpeg,
    ".jpeg": ImageFormat.Jpeg,
    ".gif": ImageFormat.Gif,
    ".webp": ImageFormat.WebP,
    ".pnm": ImageFormat.Pnm,
    ".ppm": ImageFormat.Pnm,
    ".pgm": ImageFormat.Pnm,
    ".tif": ImageFormat.Tiff,
    ".tiff": ImageFormat.Tiff,
    ".tga": ImageFormat.Tga,
    ".dds": ImageFormat.Dds,
    ".bmp": ImageFormat.Bmp,
    ".ico": ImageFormat.Ico,
    ".hdr": ImageFormat.Hdr,
    ".exr": ImageFormat.OpenExr,
    ".ff": ImageFormat.Farbfeld,
    ".avif": ImageFormat.Avif,
    ".qoi": ImageFormat.Qoi,
    ".jxl": ImageFormat.Jxl,
    ".jxt": ImageFormat.Jxt,
}


def format_from_path(path: str) -> ImageFormat:
    return _EXT_TO_FORMAT.get(os.path.splitext(path)[1].lower(), ImageFormat.Unsupported)


@dataclass
class ImageFileData:
    """Per-file metadata record (13-column CSV schema parity, SURVEY §2.1)."""

    image_name: str = ""
    commit: str = ""  # codec variant id in this framework (strategy name)
    test_set: str = ""
    file_path: str = ""
    width: int = 0
    height: int = 0
    file_size: int = 0
    raw_size: int = 0
    color_space: ColorType = ColorType.Rgb8
    format: ImageFormat = ImageFormat.Unsupported
    # JXT/JXL-only fields (None for source images):
    jxl_orig_image_name: Optional[str] = None
    jxl_distance: Optional[float] = None
    jxl_effort: Optional[int] = None

    def csv_row(self) -> list:
        opt = lambda v: "" if v is None else v  # noqa: E731
        return [
            self.image_name,
            self.commit,
            self.test_set,
            self.file_path,
            self.width,
            self.height,
            self.file_size,
            self.raw_size,
            self.color_space.value,
            self.format.value,
            opt(self.jxl_orig_image_name),
            opt(self.jxl_distance),
            opt(self.jxl_effort),
        ]
