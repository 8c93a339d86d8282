"""Where do the bits go? Per-section rate breakdown of a JXT encode.

Reproduces the encoder's token stream (codec/encode.tokens_from_rgb), its
clustered+quantized histograms, and charges every token its actual rANS
cost log2(M / f[ctx, tok]) plus mantissa bytes — aggregated by stream
section (ACS map, quant field, CfL, DC per channel, AC per channel x band)
plus the padding tokens and the container's header / freq-table / states
overhead. The sum reconciles against the real container size (rANS coding
loss vs the ideal is < 0.1%), so the table IS the file.

Usage: python tools/bit_breakdown.py [image.png] [-d 1.0] [-e 7]
Add --jpeg to print a PIL JPEG bpp-at-matched-PSNR anchor.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

if os.environ.get("JXL_JAX_BREAKDOWN_CPU", "1") == "1":
    # bit counts are platform-independent: run on the CPU
    os.environ["JAX_PLATFORMS"] = "cpu"


def breakdown(rgb, distance=1.0, effort=7):
    import jax.numpy as jnp

    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.encode import (
        _histogram_stepped,
        _step_ctx_v8,
        encode_image,
        pick_lanes,
    )
    from jxl_jax.codec.analysis import encode_tokens_for_analysis as tokens_from_rgb
    from jxl_jax.codec.layout import N_BANDS, padded_layout, token_layout
    from jxl_jax.entropy.cluster import cluster_histograms_kmeans
    from jxl_jax.entropy.rans import RANS_M, quantize_histograms_t
    from jxl_jax.entropy.tokens import ALPHABET

    h, w = rgb.shape[:2]
    lay = token_layout(h, w)
    token, nbits, mant, params, q_sorted = tokens_from_rgb(
        jnp.asarray(rgb), distance, height=h, width=w, effort=effort
    )

    # v8 accounting: charge every token its ACTUAL coded cost — the rANS
    # bits under its STEP's context (nnz-conditioned for the AC phase,
    # boundary-step mismatch included), exactly the encoder's tables
    # (stepped histogram -> k-means clustering -> 12-bit quantization).
    lanes = pick_lanes(lay["n_tokens"], 256)
    play = padded_layout(h, w, lanes)
    step_ctx = _step_ctx_v8(play, q_sorted)
    tokp = jnp.zeros((play["n_padded"],), jnp.int32)
    src = 0
    tok_ctx = np.empty(lay["n_tokens"], np.int32)
    step_ctx_np = np.asarray(step_ctx)
    ctx_padded = np.repeat(step_ctx_np, lanes)
    for _c, dst, n_real, _n_pad in play["spans"]:
        tokp = tokp.at[dst : dst + n_real].set(token[src : src + n_real])
        tok_ctx[src : src + n_real] = ctx_padded[dst : dst + n_real]
        src += n_real
    counts = _histogram_stepped(tokp, step_ctx, lanes, play["n_ctx"])
    cmap, ctables = cluster_histograms_kmeans(counts, k=64)
    freqK, _ = quantize_histograms_t(ctables)
    freq = np.asarray(freqK)[np.asarray(cmap)].astype(np.float64)
    bits_tab = np.log2(RANS_M / np.maximum(freq, 1.0))  # [C, A]

    token = np.asarray(token)
    nbits = np.asarray(nbits)
    tok_bits = bits_tab[tok_ctx, token]
    mant_bits = 8.0 * ((nbits + 7) // 8)

    # section slicing (AC sections hold the same tokens whatever the
    # bucket sort order — per-(channel, band) attribution is order-free)
    nb = lay["nb"]
    n_cfl = lay["n_cfl"]
    secs = []
    o = 0
    secs.append(("acs_map", o, o + nb)); o += nb
    secs.append(("quant_field", o, o + nb)); o += nb
    secs.append(("cfl", o, o + n_cfl)); o += n_cfl
    for c, nm in enumerate("XYB"):
        secs.append((f"nnz_{nm}", o, o + nb)); o += nb
    for c, nm in enumerate("XYB"):
        secs.append((f"dc_{nm}", o, o + nb)); o += nb
    band_sizes = [np.sum(np.asarray(
        __import__("jxl_jax.codec.layout", fromlist=["ac_band_table"]).ac_band_table()
    ) == b) * nb for b in range(N_BANDS)]
    for c, nm in enumerate("XYB"):
        for b in range(N_BANDS):
            n = int(band_sizes[b])
            secs.append((f"ac_{nm}_b{b}", o, o + n)); o += n
    assert o == lay["n_tokens"], (o, lay["n_tokens"])

    rows = []
    for name, s, e in secs:
        tb = float(tok_bits[s:e].sum())
        mb = float(mant_bits[s:e].sum())
        nz = int((token[s:e] != 0).sum())
        rows.append((name, tb, mb, e - s, nz))

    # padding tokens: zeros coded in their step's context
    pad_bits = 0.0
    src = 0
    for _c, dst, n_real, n_pad in play["spans"]:
        pads = ctx_padded[dst + n_real : dst + n_pad]
        pad_bits += float(bits_tab[pads, 0].sum())
        src += n_real

    data = encode_image(rgb, CodecConfig(distance=distance, effort=effort))
    total_bytes = len(data)

    # container overhead: parse pieces
    from jxl_jax.codec.container import read_container

    stream = read_container(data)
    words_b = len(stream.stream_words)
    mant_b = len(stream.mant_bytes)
    hdr_b = total_bytes - words_b - mant_b

    n_px = h * w
    print(f"image {w}x{h}  d={distance} e={effort}  "
          f"total {total_bytes} B = {total_bytes * 8 / n_px:.4f} bpp")
    print(f"  header+tables+states: {hdr_b} B ({hdr_b * 8 / n_px:.4f} bpp)")
    print(f"  rANS words: {words_b} B   mantissa: {mant_b} B")
    print(f"  padding tokens: {pad_bits / 8:.0f} B ({pad_bits / n_px:.4f} bpp)")
    print()
    print(f"{'section':<14}{'tok_bits':>12}{'mant_bits':>11}{'bpp':>9}"
          f"{'ntok':>9}{'nonzero':>9}{'b/tok':>8}")
    tot_tb = tot_mb = 0.0
    for name, tb, mb, n, nz in rows:
        tot_tb += tb; tot_mb += mb
        print(f"{name:<14}{tb:>12.0f}{mb:>11.0f}{(tb + mb) / n_px:>9.4f}"
              f"{n:>9}{nz:>9}{tb / max(n, 1):>8.3f}")
    print(f"{'SUM':<14}{tot_tb:>12.0f}{tot_mb:>11.0f}"
          f"{(tot_tb + tot_mb) / n_px:>9.4f}")
    ideal = (tot_tb + tot_mb + pad_bits) / 8 + hdr_b
    print(f"ideal total {ideal:.0f} B vs actual {total_bytes} B "
          f"(coding loss {(total_bytes - ideal) / total_bytes * 100:.2f}%)")
    return data


def jpeg_anchor(rgb, target_psnr):
    """PIL JPEG bpp at (approximately) the same PSNR."""
    import io

    from PIL import Image

    im = Image.fromarray(rgb)
    n_px = rgb.shape[0] * rgb.shape[1]
    print("\nJPEG anchor (PIL):")
    for q in (70, 80, 85, 90, 92, 95):
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=q)
        dec = np.asarray(Image.open(buf)).astype(np.float64)
        mse = ((dec - rgb.astype(np.float64)) ** 2).mean()
        psnr = 10 * np.log10(255.0**2 / mse)
        print(f"  q={q}: {buf.tell() * 8 / n_px:.4f} bpp  {psnr:.2f} dB")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default="test_images/synth/synth00.png")
    ap.add_argument("-d", type=float, default=1.0)
    ap.add_argument("-e", type=int, default=7)
    ap.add_argument("--jpeg", action="store_true")
    args = ap.parse_args()

    from jxl_jax.core.io import read_image
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes

    rgb = read_image(args.image)
    data = breakdown(rgb, args.d, args.e)
    dec = decode_bytes(data)
    mse = ((dec.astype(np.float64) - rgb.astype(np.float64)) ** 2).mean()
    psnr = 10 * np.log10(255.0**2 / mse)
    print(f"decode PSNR {psnr:.2f} dB")
    if args.jpeg:
        jpeg_anchor(rgb, psnr)


if __name__ == "__main__":
    main()
