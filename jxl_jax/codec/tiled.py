"""Striped gigapixel codec path — bounded-memory streaming + mesh sharding.

The north star (BASELINE.json config 5) calls for gigapixel images encoded
as independently-coded sections sharded across chips, with boundary effects
handled by collectives. libjxl gets this from its 256x256 group structure
(every group is an independently entropy-coded bitstream section inside one
codestream); the equivalent here is VERTICAL STRIPES:

- A `JXTS` wrapper container holds N independent `.jxt` sections, each a
  full-height stripe of the image (widths multiples of 8 px). Every section
  is a standard single-image container — own AC-strategy map, adaptive
  quant field, per-stripe clustered histograms, grouped rANS streams.
- Encoding streams stripe-by-stripe through the bounded single-image
  pipeline (`encode_images`' dispatch/finalize overlap), so peak device
  memory is ONE stripe's working set regardless of image size — the
  whole-image arrays that would OOM at 16K x 16K never exist.
- On a device mesh the stripes ARE the data-parallel batch:
  `encode_image_striped_sharded` runs the full per-stripe pipeline SPMD via
  `distributed.sharded.encode_batch_sharded` (one jit over the mesh), and
  each device's packed buffer becomes one section — byte-identical to the
  sequential striped encode (tested).
- Decode stitches in PLANE space: every section decodes to pre-EPF XYB
  planes (`decode.decode_stream_planes`), the stripes concatenate on
  device, and ONE EPF pass runs over the full stitched image — the seam
  columns are filtered with their true cross-stripe neighbors (the
  single-host analog of `sharded_epf`'s ppermute halo exchange), not
  replicated edges.

Seam semantics: sections are coded independently (DC prediction, CfL tiles
and histogram clustering reset per stripe — a few bytes per stripe), which
is exactly the independence libjxl grants its groups; EPF is the only
cross-stripe operator and it runs seam-exactly at stitch time.
"""

from __future__ import annotations

import struct
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jxl_jax.codec.config import CodecConfig
from jxl_jax.codec.container import read_container, read_container_header
from jxl_jax.core.xyb import xyb_to_srgb
from jxl_jax.transforms.epf import epf_apply

STRIPED_MAGIC = b"JXTS"
STRIPED_VERSION = 1

# Default stripe sizing: bound the per-stripe working set to roughly this
# many megapixels.
DEFAULT_STRIPE_MP = 8.0


def stripe_widths(width: int, n_stripes: int) -> list[int]:
    """Split `width` into n stripes, each a multiple of 8 px (the block
    unit); the last stripe absorbs the remainder."""
    assert width >= 8 * n_stripes, f"width {width} too small for {n_stripes} stripes"
    base = (width // n_stripes) // 8 * 8
    widths = [base] * n_stripes
    widths[-1] = width - base * (n_stripes - 1)
    return widths


def default_n_stripes(height: int, width: int, stripe_mp: float = DEFAULT_STRIPE_MP) -> int:
    n = max(1, int(np.ceil(height * width / (stripe_mp * 1e6))))
    return min(n, max(1, width // 256))  # keep stripes >= 256 px wide


def write_striped(height: int, width: int, sections: list[bytes]) -> bytes:
    head = struct.pack(
        "<4sBBHII",
        STRIPED_MAGIC,
        STRIPED_VERSION,
        0,
        len(sections),
        height,
        width,
    )
    lens = struct.pack(f"<{len(sections)}I", *(len(s) for s in sections))
    return head + lens + b"".join(sections)


def read_striped(data: bytes):
    """-> (height, width, [section bytes]). Raises ValueError on any
    malformed wrapper (same hardening contract as container.read_container):
    every declared length is validated against the
    remaining buffer before any section parse or allocation."""
    from jxl_jax.codec.container import MAX_DIM, _check

    _check(data[:4] == STRIPED_MAGIC, "bad magic (not a striped JXT stream)")
    try:
        magic, version, _flags, n, height, width = struct.unpack_from(
            "<4sBBHII", data, 0
        )
        _check(
            version == STRIPED_VERSION, f"unknown striped version {version}"
        )
        _check(
            0 < height <= MAX_DIM and 0 < width <= MAX_DIM and n >= 1,
            "bad striped geometry",
        )
        off = struct.calcsize("<4sBBHII")
        _check(off + 4 * n <= len(data), "section table overruns buffer")
        lens = struct.unpack_from(f"<{n}I", data, off)
    except struct.error as e:
        raise ValueError(f"malformed striped container: truncated ({e})") from e
    off += 4 * n
    sections = []
    for L in lens:
        # validate declared lengths so truncated/corrupt input fails at the
        # wrapper parse, not as a confusing container error sections later
        _check(
            off + L <= len(data),
            f"striped section needs bytes [{off}, {off + L}) of {len(data)}",
        )
        sections.append(data[off : off + L])
        off += L
    _check(off == len(data), f"{len(data) - off} trailing bytes")
    return height, width, sections


def is_striped(data: bytes) -> bool:
    return data[:4] == STRIPED_MAGIC


def encode_image_striped(
    rgb: np.ndarray,
    config: CodecConfig,
    n_stripes: int | None = None,
    orig_name: str = "",
) -> bytes:
    """Encode as N independent full-height stripes (bounded device memory:
    the pipeline holds one stripe's working set at a time)."""
    from jxl_jax.codec.encode import encode_images

    rgb = np.asarray(rgb)
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    if n_stripes is None:
        n_stripes = default_n_stripes(h, w)
    # every SECTION must satisfy the hardened decoder's single-section cap
    # (container.MAX_PIXELS): raise a too-small user/default stripe count
    # rather than writing a container our own decoder rejects
    from jxl_jax.codec.container import MAX_PIXELS

    min_stripes = -(-h * w // MAX_PIXELS)
    if n_stripes < min_stripes:
        n_stripes = min_stripes
    assert w >= 8 * n_stripes and h <= MAX_PIXELS // 8, (
        f"{h}x{w} cannot be striped into <= {MAX_PIXELS}-pixel sections"
    )
    widths = stripe_widths(w, n_stripes)
    edges = np.concatenate([[0], np.cumsum(widths)])
    stripes = [rgb[:, edges[i] : edges[i + 1]] for i in range(n_stripes)]
    names = [orig_name if i == 0 else "" for i in range(n_stripes)]
    # Per-STRIPE coding-mode decisions (round 5): mixed-content images
    # (screenshot + photo inset) lose ~20% bytes to a whole-image
    # decision; vertical stripes are the per-region granularity, and the
    # decoder stitches mixed vardct/modular sections (vardct runs get
    # their seam-exact EPF per contiguous run). Non-candidate content
    # keeps the batched single-program fast path and byte-identical
    # output.
    from jxl_jax.codec.encode import _modular_candidate

    per_stripe_modes = (
        config.modular
        and config.distance > 0
        and n_stripes > 1
        and _modular_candidate(rgb)
    )
    if n_stripes > 1 and not per_stripe_modes:
        from dataclasses import replace as _replace

        config = _replace(config, modular=False)
    if (
        len(set(widths)) == 1
        and config.distance > 0
        and n_stripes > 1
        and not per_stripe_modes
    ):
        # Equal-width lossy stripes encode as batched device dispatches
        # (one dispatch per chunk instead of one per stripe), chunked with
        # a DEPTH-2 pipeline: chunk k+1's
        # raw-pixel H2D upload — the dominant cost at multi-MP sizes —
        # overlaps chunk k's compute, while at most two chunks are ever
        # device-resident. The chunk size is capped by a pixel budget so
        # gigapixel images never batch unbounded stripes into one
        # dispatch (a ceil(n/2) split would keep half the image
        # resident), and prefers a divisor of n_stripes so ONE
        # compiled batch program covers every chunk.
        from jxl_jax.codec.encode import encode_images_batched_async

        budget_px = 32e6  # ~2 chunks x 32 MP resident worst-case
        c_max = max(1, min(n_stripes, int(budget_px // (h * widths[0]))))
        chunk = 1
        for c in range(c_max, 1, -1):
            if n_stripes % c == 0:
                chunk = c
                break
        sections = []
        pending = []
        for s in range(0, n_stripes, chunk):
            pending.append(
                encode_images_batched_async(
                    stripes[s : s + chunk],
                    config,
                    orig_names=names[s : s + chunk],
                )
            )
            if len(pending) >= 2:
                sections.extend(pending.pop(0)())
        for f in pending:
            sections.extend(f())
    else:
        sections = encode_images(
            [(s, config, nm) for s, nm in zip(stripes, names)]
        )
    return write_striped(h, w, sections)


def encode_image_striped_sharded(
    rgb: np.ndarray,
    config: CodecConfig,
    mesh=None,
    n_stripes: int | None = None,
    orig_name: str = "",
) -> bytes:
    """Mesh-sharded striped encode: the stripes are the data-parallel batch
    of ONE SPMD program (distributed.sharded.encode_batch_sharded), so an
    N-device mesh encodes N stripes concurrently. Sections are byte-
    identical to the sequential `encode_image_striped` (equal-width stripes
    required: width must divide by 8 * n_stripes)."""
    from jxl_jax.distributed.mesh import make_mesh
    from jxl_jax.distributed.sharded import encode_batch_sharded

    rgb = np.asarray(rgb)
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    # encode_batch_sharded floors distance at 0.05 and always runs the
    # lossy pipeline; a d=0 request must not silently encode lossy
    # sections (the sequential encode_image_striped would emit true
    # lossless ones, breaking the byte-identical contract).
    assert config.distance > 0.0, (
        "lossless (d=0) striped encode is sequential-only: use "
        "encode_image_striped (the SPMD batch path has no modular mode)"
    )
    if mesh is None:
        mesh = make_mesh()
    if n_stripes is None:
        n_stripes = int(mesh.shape["data"])
    assert w % (8 * n_stripes) == 0, (
        f"sharded striping needs equal block-aligned stripes: width {w} "
        f"must divide by {8 * n_stripes}"
    )
    ws = w // n_stripes
    stripes = [rgb[:, i * ws : (i + 1) * ws] for i in range(n_stripes)]
    names = [orig_name] + [""] * (n_stripes - 1)
    sections = encode_batch_sharded(stripes, config, mesh=mesh, orig_names=names)
    return write_striped(h, w, sections)


@partial(jax.jit, static_argnames=("height", "width", "epf"))
def _stitch_finish(planes, eff_mul, distance, *, height, width, epf):
    """Stitched pre-EPF planes -> RGB u8: one seam-exact EPF pass over the
    full image, then the inverse color transform (B coded as Y-residual)."""
    if epf:
        planes = epf_apply(planes, eff_mul, distance)
    planes = planes[:, :height, :width]
    x, y, b_res = planes[0], planes[1], planes[2]
    xyb = jnp.stack([x, y, b_res + y], axis=-1)
    return jnp.round(xyb_to_srgb(xyb) * 255.0).astype(jnp.uint8)


def decode_striped_device(data: bytes):
    """Striped container -> RGB u8 [H, W, 3] device array.

    Sections may MIX coding families (round 5: per-stripe VarDCT-vs-
    modular decisions on candidate content). Modular sections decode to
    RGB directly; each maximal run of consecutive VarDCT sections is
    stitched in plane space and gets its own seam-exact EPF pass (EPF is
    a local filter — at a vardct/modular boundary the content families
    differ, so edge replication there is the natural behavior)."""
    height, width, sections = read_striped(data)
    headers = [read_container_header(s) for s in sections]
    from jxl_jax.codec.decode import decode_bytes_device, decode_stream_planes

    if all(h.lossless for h in headers):
        parts = [decode_bytes_device(s) for s in sections]
        return jnp.concatenate(parts, axis=1)

    d0 = headers[0].distance
    for hs in headers:
        # a heterogeneous distance (hand-built container) would silently
        # filter/dequantize with the wrong strength; same ValueError
        # contract as the hardened parsers
        if hs.distance != d0:
            raise ValueError(
                "malformed striped container: sections disagree on distance"
            )

    rgb_parts = []  # per maximal run: RGB u8 [H, run_w, 3]
    i = 0
    while i < len(sections):
        if headers[i].lossless:
            rgb_parts.append(decode_bytes_device(sections[i]))
            i += 1
            continue
        # maximal VarDCT run [i, j): stitch planes, one EPF over the run
        j = i
        planes_parts, mul_parts, epf_votes = [], [], 0
        while j < len(sections) and not headers[j].lossless:
            epf_votes += 1 if headers[j].epf else 0
            planes, eff_mul = decode_stream_planes(read_container(sections[j]))
            planes_parts.append(planes)
            mul_parts.append(eff_mul)
            j += 1
        planes = jnp.concatenate(planes_parts, axis=-1)
        eff_mul = jnp.concatenate(mul_parts, axis=-1)
        run_w = planes.shape[-1]  # padded run width (8-multiples)
        rgb_parts.append(
            _stitch_finish(
                planes,
                eff_mul,
                jnp.float32(d0),
                height=height,
                width=run_w,
                epf=epf_votes * 2 > (j - i),
            )
        )
        i = j
    out = jnp.concatenate(rgb_parts, axis=1)
    return out[:, :width]


def decode_striped_bytes(data: bytes) -> np.ndarray:
    return np.asarray(jax.device_get(decode_striped_device(data)))
