"""Corpus-wide RD position report: for EVERY committed
corpus image, the codec's bpp at its flagship (d=1) PSNR against the
image's own Gaussian water-filling bound and same-PSNR WebP/JPEG anchors,
plus per-family aggregates. Replaces the single-image claim in
docs/rd_position.md with a corpus-mean one.

Writes docs/rd_position_r05.md.

Run: python tools/rd_position_corpus.py   (GPU preferred; CPU works —
set JAX_PLATFORMS=cpu — the numbers are platform-independent)
"""

import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

FAMILY = {
    "synth00": "photo", "synth01": "photo", "synth04": "photo", "synth05": "photo",
    "synth02": "graphics", "synth06": "graphics",
    "synth03": "portrait", "synth07": "portrait",
    "synth08": "text", "synth11": "text",
    "synth09": "diagonal", "synth10": "sky",
}

DISTANCES = (0.5, 0.7, 1.0, 1.4, 2.0)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-9))


def anchor_bpp_curve(rgb, fmt, qualities, **kw):
    """[(bpp, psnr)] for a PIL codec's quality ladder."""
    from PIL import Image

    im = Image.fromarray(rgb)
    n_px = rgb.shape[0] * rgb.shape[1]
    pts = []
    for q in qualities:
        buf = io.BytesIO()
        im.save(buf, fmt, quality=q, **kw)
        buf.seek(0)
        dec = np.asarray(Image.open(buf).convert("RGB"))
        pts.append((buf.getbuffer().nbytes * 8 / n_px, psnr(rgb, dec)))
    return pts


def interp_bpp(pts, target):
    """log-bpp interpolation at a PSNR target; nan outside the range."""
    pts = sorted(pts, key=lambda p: p[1])
    ps = np.array([p[1] for p in pts])
    bs = np.log([max(p[0], 1e-9) for p in pts])
    if not (ps[0] <= target <= ps[-1]):
        return float("nan")
    return float(np.exp(np.interp(target, ps, bs)))


def main():
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes_grid_stacked, decode_bytes
    from jxl_jax.codec.encode import encode_image_grid
    from jxl_jax.core.io import read_image
    from tools.rd_bound import bound_bpp, coeff_vars

    rows = []
    names = sorted(FAMILY)
    for name in names:
        rgb = read_image(f"test_images/synth/{name}.png")
        n_px = rgb.shape[0] * rgb.shape[1]
        cfg = CodecConfig(distance=1.0, effort=7)
        datas = encode_image_grid(rgb, cfg, list(DISTANCES))
        stacked = decode_bytes_grid_stacked(datas)
        if stacked is not None:
            outs = np.asarray(stacked)
        else:
            outs = np.stack([np.asarray(decode_bytes(d)) for d in datas])
        codec_pts = [
            (len(d) * 8 / n_px, psnr(rgb, outs[i]))
            for i, d in enumerate(datas)
        ]
        target = codec_pts[DISTANCES.index(1.0)][1]  # flagship PSNR
        codec_bpp = codec_pts[DISTANCES.index(1.0)][0]

        v8, n8 = coeff_vars(rgb, 8)
        bound = bound_bpp(v8, n8, target)
        jpeg = interp_bpp(
            anchor_bpp_curve(rgb, "JPEG", (60, 70, 80, 85, 90, 92, 95, 97)),
            target,
        )
        webp = interp_bpp(
            anchor_bpp_curve(
                rgb, "WEBP", (50, 60, 70, 80, 85, 90, 93, 95, 98), method=6
            ),
            target,
        )
        rows.append(
            dict(
                name=name, family=FAMILY[name], target=target,
                codec=codec_bpp, bound=bound, jpeg=jpeg, webp=webp,
            )
        )
        print(json.dumps(rows[-1]), flush=True)

    lines = [
        "# Corpus-wide RD position — round 5",
        "",
        "Generated by `tools/rd_position_corpus.py`: for each of the 12",
        "committed corpus images, this codec's bpp at its OWN d=1 e7",
        "operating point (the flagship distance) against the image's",
        "Gaussian reverse-water-filling bound (tools/rd_bound.py",
        "methodology; approximate — for non-Gaussian content the true",
        "bound is lower) and WebP (-m6-equivalent, method=6) / JPEG",
        "anchors log-interpolated to the SAME PSNR. `nan` anchors mean",
        "the anchor's quality ladder cannot reach that PSNR.",
        "",
        "| image | family | PSNR (dB) | codec bpp | bound bpp | codec/bound | WebP bpp | codec/WebP | JPEG bpp | codec/JPEG |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        cw = r["codec"] / r["webp"] if np.isfinite(r["webp"]) else float("nan")
        cj = r["codec"] / r["jpeg"] if np.isfinite(r["jpeg"]) else float("nan")
        lines.append(
            f"| {r['name']} | {r['family']} | {r['target']:.2f} | "
            f"{r['codec']:.4f} | {r['bound']:.4f} | "
            f"{r['codec'] / max(r['bound'], 1e-9):.2f} | "
            f"{r['webp']:.4f} | {cw:.2f} | {r['jpeg']:.4f} | {cj:.2f} |"
        )

    # per-family + corpus means (geometric, over images with finite anchors)
    def gmean(vals):
        vals = [v for v in vals if np.isfinite(v)]
        return float(np.exp(np.mean(np.log(vals)))) if vals else float("nan")

    lines += ["", "| family | codec/bound | codec/WebP | codec/JPEG | n |", "|---|---|---|---|---|"]
    fams = sorted(set(FAMILY.values()))
    for fam in fams + ["ALL"]:
        sel = [r for r in rows if fam == "ALL" or r["family"] == fam]
        rb = gmean([r["codec"] / r["bound"] for r in sel])
        rw = gmean([
            r["codec"] / r["webp"] for r in sel if np.isfinite(r["webp"])
        ])
        rj = gmean([
            r["codec"] / r["jpeg"] for r in sel if np.isfinite(r["jpeg"])
        ])
        lines.append(f"| {fam} | {rb:.2f} | {rw:.2f} | {rj:.2f} | {len(sel)} |")

    lines += [
        "",
        "Ratios are geometric means; codec/X < 1 means this codec needs",
        "fewer bits than X at the same PSNR on that content.",
        "",
        "Reading the table honestly:",
        "",
        "- **codec/bound < 1 on sharp families does NOT mean the codec",
        "  beats information theory** — it means the GAUSSIAN bound is",
        "  loose there (graphics/text/diagonal coefficients are wildly",
        "  non-Gaussian). The bound is only a meaningful ceiling on the",
        "  noise-dominated photo family.",
        "- Round 5 adds the MODULAR-LOSSY mode (codec/lossless.py,",
        "  round 4): on candidate content the encoder also",
        "  codes a quantized-plane modular stream and keeps whichever",
        "  container measures better. The sharp-content columns below are",
        "  therefore the round-4 numbers' direct successors: round 4",
        "  measured graphics 3.80x / text 1.64x / diagonal 1.89x WebP",
        "  and corpus geomean 1.12x.",
    ]
    os.makedirs("docs", exist_ok=True)
    with open("docs/rd_position_r05.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote docs/rd_position_r05.md")


if __name__ == "__main__":
    main()
