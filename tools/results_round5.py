"""Aggregate a corpus sweep run into docs/results_round5/ (round-5
results artifact: the first sweep with the per-image VarDCT-vs-modular
mode decision live in the harness).

Usage: python tools/results_round5.py <run_dir>/synth/BASELINE/results
"""

import csv
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tools.rd_position_corpus import FAMILY


def main():
    res_dir = sys.argv[1]
    out_dir = "docs/results_round5"
    os.makedirs(out_dir, exist_ok=True)
    comp = os.path.join(res_dir, "comparisons.csv")
    shutil.copy(comp, os.path.join(out_dir, "comparisons.csv"))

    rows = list(csv.DictReader(open(comp)))
    # container mode per artifact: flags bit 1 of the .jxt next to results
    mode = {}
    for dirpath, _dirs, files in os.walk(os.path.dirname(res_dir)):
        for f in files:
            if f.endswith(".jxt"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    head = fh.read(24)
                # magic4 + ver1 + h4 + w4 + dist4 + effort1 + strategy1
                if len(head) >= 20 and head[:4] == b"JXT1":
                    mode[f] = bool(head[19] & 2)  # flags byte, bit 1

    fam_eff = {}
    pick_counts = {}
    for r in rows:
        name = r["Original Image Name"].replace(".png", "")
        fam = FAMILY.get(name, "?")
        d = float(r["Distance"])
        e = int(r["Effort"])
        comp_name = r["Compressed Image Name"]
        modular = mode.get(comp_name)
        n_px = float(r["Original Raw Size"]) / 3.0
        bpp = float(r["Compressed File Size"]) * 8 / n_px
        psnr = float(r["PSNR"])
        fam_eff.setdefault((fam, e), []).append((bpp, psnr))
        if modular is not None:
            k = (fam, "modular" if modular else "vardct")
            pick_counts[k] = pick_counts.get(k, 0) + 1

    lines = [
        "# Round-5 corpus sweep (rust grid, BASELINE, mode decision live)",
        "",
        "Full 50-point grid (10 distances x 5 efforts) over the 12-image",
        "corpus, run through the real harness (`python -m jxl_jax bench",
        "--grid rust`) with the round-5 per-image VarDCT-vs-modular",
        "decision active. `comparisons.csv` is the raw 17-column output.",
        "",
        "## Mean (bpp, PSNR) by family x effort",
        "",
        "| family | " + " | ".join(f"e{e}" for e in (5, 6, 7, 8, 9)) + " |",
        "|---|---|---|---|---|---|",
    ]
    for fam in sorted(set(f for f, _ in fam_eff)):
        cells = []
        for e in (5, 6, 7, 8, 9):
            pts = fam_eff.get((fam, e), [])
            if pts:
                cells.append(
                    f"{np.mean([p[0] for p in pts]):.3f} bpp / "
                    f"{np.mean([p[1] for p in pts]):.1f} dB"
                )
            else:
                cells.append("—")
        lines.append(f"| {fam} | " + " | ".join(cells) + " |")

    lines += ["", "## Coding-mode picks by family (all 50 points x images)", ""]
    lines += ["| family | vardct | modular |", "|---|---|---|"]
    fams = sorted(set(f for f, _m in pick_counts))
    for fam in fams:
        lines.append(
            f"| {fam} | {pick_counts.get((fam, 'vardct'), 0)} | "
            f"{pick_counts.get((fam, 'modular'), 0)} |"
        )
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote", out_dir)


if __name__ == "__main__":
    main()
