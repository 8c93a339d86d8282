"""RD-gated Hook A corpus A/B.

Round 4's 600-point thesis A/B found the homogeneity override pays in
exactly one regime — near-ties of the dense search's rate proxy (text:
+0.123 dB for +611 B); unconditionally it loses elsewhere. This tool
A/Bs the modernized tie-breaker form (Strategy.HOMOGENEITY_RD_GATED,
strategy/acs.py) against BASELINE and the thesis's unconditional
HOMOGENEITY_PARTITIONING on the full committed corpus.

Writes docs/hooka_gated_r05.md. Run: python tools/hooka_gated_ab.py
(GPU preferred; JAX_PLATFORMS=cpu works).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tools.rd_position_corpus import FAMILY

DISTANCES = (1.0, 3.0)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-9))


def main():
    os.environ["JXL_JAX_MODULAR"] = "0"  # isolate the VarDCT path
    from jxl_jax.codec.config import CodecConfig, Strategy
    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.codec.encode import encode_image_grid
    from jxl_jax.core.io import read_image

    arms = ("BASELINE", "HOMOGENEITY_PARTITIONING", "HOMOGENEITY_RD_GATED")
    rows = []
    for name in sorted(FAMILY):
        rgb = read_image(f"test_images/synth/{name}.png")
        n_px = rgb.shape[0] * rgb.shape[1]
        per = {}
        for arm in arms:
            cfg = CodecConfig(distance=1.0, effort=7, strategy=Strategy[arm])
            datas = encode_image_grid(rgb, cfg, list(DISTANCES))
            per[arm] = [
                (len(d), psnr(rgb, np.asarray(decode_bytes(d)))) for d in datas
            ]
        for i, d in enumerate(DISTANCES):
            r = dict(name=name, family=FAMILY[name], d=d)
            for arm in arms:
                r[f"{arm}_bytes"], r[f"{arm}_psnr"] = per[arm][i]
            rows.append(r)
            print(json.dumps(r), flush=True)

    lines = [
        "# RD-gated Hook A — corpus A/B (round 5)",
        "",
        "`HOMOGENEITY_RD_GATED` applies the thesis's HomogeneityPartition",
        "override ONLY where the partitioned candidate is within",
        "JXL_JAX_HOOKA_EPS (default 2%) of the dense argmin winner's proxy",
        "rate — the near-tie regime the round-4 600-point study identified",
        "as the one place the heuristic pays. VarDCT path isolated",
        "(modular decision pinned off); deltas vs BASELINE at equal d.",
        "",
        "| image | family | d | base bytes | base PSNR | HookA dB / dbytes | gated dB / dbytes |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['family']} | {r['d']} | "
            f"{r['BASELINE_bytes']} | {r['BASELINE_psnr']:.3f} | "
            f"{r['HOMOGENEITY_PARTITIONING_psnr'] - r['BASELINE_psnr']:+.3f} / "
            f"{r['HOMOGENEITY_PARTITIONING_bytes'] - r['BASELINE_bytes']:+d} | "
            f"{r['HOMOGENEITY_RD_GATED_psnr'] - r['BASELINE_psnr']:+.3f} / "
            f"{r['HOMOGENEITY_RD_GATED_bytes'] - r['BASELINE_bytes']:+d} |"
        )

    def mean(k):
        return float(np.mean([r[k] for r in rows]))

    lines += [
        "",
        f"Corpus means: HookA {mean('HOMOGENEITY_PARTITIONING_psnr') - mean('BASELINE_psnr'):+.4f} dB "
        f"for {mean('HOMOGENEITY_PARTITIONING_bytes') - mean('BASELINE_bytes'):+.0f} B; "
        f"gated {mean('HOMOGENEITY_RD_GATED_psnr') - mean('BASELINE_psnr'):+.4f} dB "
        f"for {mean('HOMOGENEITY_RD_GATED_bytes') - mean('BASELINE_bytes'):+.0f} B.",
    ]
    with open("docs/hooka_gated_r05.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote docs/hooka_gated_r05.md")


if __name__ == "__main__":
    main()
