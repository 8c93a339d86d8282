"""Measure (bpp, PSNR) RD points of the current codec configuration.

Encodes the bench image (bench.synth_kodak) plus a few corpus-style
synthetic images over a distance sweep, decodes, and prints ONE JSON line:
{image: [[d, bpp, psnr], ...]}. Honors every JXL_JAX_* tuning env var, so
tools/rd_tune.py can A/B parameter settings via subprocesses (the quant
tables are module constants read at import).

Runs on whatever platform JAX selects (the GPU when available).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from bench import synth_kodak
    from tools.make_test_images import synth_photo
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes_grid_stacked, decode_bytes
    from jxl_jax.codec.encode import encode_image_grid

    effort = int(os.environ.get("RD_EFFORT", "7"))
    dists = [float(s) for s in os.environ.get(
        "RD_DISTANCES", "0.7,0.85,1.0,1.2,1.45"
    ).split(",")]
    n_corpus = int(os.environ.get("RD_CORPUS", "3"))

    images = {"bench": synth_kodak()}
    for i in range(n_corpus):
        images[f"synth{i}"] = synth_photo(512, 768, seed=100 + i)

    cfg = CodecConfig(distance=1.0, effort=effort)
    out = {}
    for name, img in images.items():
        h, w = img.shape[:2]
        datas = encode_image_grid(img, cfg, dists)
        dec = decode_bytes_grid_stacked(datas)
        dec = np.asarray(dec) if dec is not None else np.stack(
            [decode_bytes(d) for d in datas]
        )
        pts = []
        ref = img.astype(np.float64)
        for i, d in enumerate(dists):
            mse = ((dec[i].astype(np.float64) - ref) ** 2).mean()
            psnr = 10 * np.log10(255.0**2 / mse)
            pts.append([d, len(datas[i]) * 8 / (h * w), round(psnr, 4)])
        out[name] = pts
    print(json.dumps(out))


if __name__ == "__main__":
    main()
