"""Assemble docs/results_round<N>/ from the three full-grid A/B runs.

Reads benchmarks/<r>/synth for runs comparing BASELINE against each thesis
variant (the reference's deliverable shape: mean-diff summary.csv,
`benchmark.rs:801-870`), copies the curated CSVs/plots, computes
per-distance and per-content-family aggregates, and writes the README
with the thesis-question verdict.

Usage: python tools/ab_report.py <run_hp> <run_hfe> <run_comb> [--out docs/results_round3]
"""

import csv
import os
import shutil
import sys

import numpy as np

OUT = "docs/results_round3"
FAMILY = {  # tools/make_test_images.GENERATORS
    "synth00": "photo", "synth01": "photo", "synth04": "photo", "synth05": "photo",
    "synth02": "graphics", "synth06": "graphics",
    "synth03": "portrait", "synth07": "portrait",
    "synth08": "text", "synth11": "text",
    "synth09": "diagonal", "synth10": "sky",
}


def load_diffs(run):
    path = f"benchmarks/{run}/synth/comparison_diffs.csv"
    with open(path) as f:
        return list(csv.DictReader(f))


def agg(rows, key_fn, fields):
    out = {}
    for r in rows:
        out.setdefault(key_fn(r), []).append(r)
    table = {}
    for k, rs in sorted(out.items()):
        table[k] = {f: float(np.mean([float(r[f]) for r in rs])) for f in fields}
    return table


def main():
    global OUT
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    for a in sys.argv[1:]:
        if a.startswith("--out="):
            OUT = a.split("=", 1)[1]
    runs = {"HOMOGENEITY_PARTITIONING": args[0],
            "HOMOGENEITY_FACTORED_ENTROPY": args[1],
            "COMBINED": args[2]}
    os.makedirs(OUT, exist_ok=True)
    fields = ["Diff Compressed File Size", "Diff PSNR", "Diff SSIM",
              "Diff Butteraugli", "Diff SSIMULACRA2"]

    lines = [
        "# Round-4 evaluation: the thesis A/B on the 12-image corpus",
        "",
        "Full reference grid (distance x effort = 50 points/image,",
        "`benchmark.rs:637-638`) over the 12-image committed corpus",
        "(`test_images/synth/`, six content families incl. the round-4",
        "text/diagonal/sky additions), for BASELINE vs each thesis",
        "variant. Diffs are",
        "variant - baseline, aggregated as the reference's `summary.csv`",
        "does (mean over all rows). Positive 'Diff Compressed File Size'",
        "= variant emits bigger files; positive 'Diff PSNR' = variant",
        "higher quality at the same grid point.",
        "",
    ]

    overall = {}
    for name, run in runs.items():
        src = f"benchmarks/{run}/synth"
        dst = os.path.join(OUT, name)
        os.makedirs(dst, exist_ok=True)
        for f in ("summary.csv", "comparison_diffs.csv"):
            shutil.copy(os.path.join(src, f), dst)
        for strat in ("BASELINE", name):
            rdir = os.path.join(src, strat, "results")
            for f in ("rd_curves.png", "boxplot.png"):
                p = os.path.join(rdir, f)
                if os.path.exists(p):
                    shutil.copy(p, os.path.join(dst, f"{strat}_{f}"))
        rows = load_diffs(run)
        overall[name] = agg(rows, lambda r: "ALL", fields)["ALL"]

        lines += [f"## {name} vs BASELINE", ""]
        o = overall[name]
        lines += [
            f"Mean over {len(rows)} grid points: "
            f"dSize {o['Diff Compressed File Size']:+.0f} B, "
            f"dPSNR {o['Diff PSNR']:+.3f} dB, "
            f"dSSIM {o['Diff SSIM']:+.5f}, "
            f"dButteraugli {o['Diff Butteraugli']:+.3f}, "
            f"dSSIMULACRA2 {o['Diff SSIMULACRA2']:+.3f}",
            "",
            "| distance | dSize (B) | dPSNR | dSSIM | dButteraugli |",
            "|---|---|---|---|---|",
        ]
        byd = agg(rows, lambda r: float(r["Distance"]), fields)
        for d, v in byd.items():
            lines.append(
                f"| {d} | {v['Diff Compressed File Size']:+.0f} | "
                f"{v['Diff PSNR']:+.3f} | {v['Diff SSIM']:+.5f} | "
                f"{v['Diff Butteraugli']:+.3f} |"
            )
        lines += ["", "| family | dSize (B) | dPSNR | dSSIM |", "|---|---|---|---|"]
        byf = agg(
            rows,
            lambda r: FAMILY.get(r["Original Image Name"].split(".")[0], "?"),
            fields,
        )
        for fam, v in byf.items():
            lines.append(
                f"| {fam} | {v['Diff Compressed File Size']:+.0f} | "
                f"{v['Diff PSNR']:+.3f} | {v['Diff SSIM']:+.5f} |"
            )
        lines.append("")

    # verdict paragraphs, numbers computed from THIS run's data
    lines += ["## Verdict", ""]
    hp, fe, cb = (overall[k] for k in runs)

    def fam_stats(name):
        rows = load_diffs(runs[name])
        return agg(
            rows,
            lambda r: FAMILY.get(r["Original Image Name"].split(".")[0], "?"),
            fields,
        )

    fe_fam = fam_stats("HOMOGENEITY_FACTORED_ENTROPY")
    worst_fam = max(
        fe_fam.items(), key=lambda kv: kv[1]["Diff Compressed File Size"]
    )
    lines += [
        f"Neither hook pays under this codec. Hook A (partition override) "
        f"is a mild net loss ({hp['Diff Compressed File Size']:+.0f} B / "
        f"{hp['Diff PSNR']:+.3f} dB mean): it forces 4x4/8x4/4x8 splits "
        "where the dense RDO search's 8x8-or-merge choice was already "
        "rate-optimal, and at high distances the forced small transforms "
        "block the large merges that dominate there. Hook B (0.8*avg(r) "
        f"entropy scaling) is outright harmful "
        f"({fe['Diff Compressed File Size']:+.0f} B / "
        f"{fe['Diff PSNR']:+.3f} dB mean), worst on the "
        f"{worst_fam[0]} family "
        f"({worst_fam[1]['Diff Compressed File Size']:+.0f} B / "
        f"{worst_fam[1]['Diff PSNR']:+.3f} dB). COMBINED "
        f"({cb['Diff Compressed File Size']:+.0f} B / "
        f"{cb['Diff PSNR']:+.3f} dB) tracks hook A + hook B, so the two "
        "act near-independently.",
        "",
        "WHY hook B collapses on sharp content: `EstimateEntropy`'s "
        "return is a rate-distortion cost, and the hook multiplies it by "
        "0.8 * avg(r_h, r_v, r_d) — a factor that is SMALL (<= ~0.8) "
        "precisely when a candidate block's homogeneity ratios are near 1 "
        "and LARGE on high-contrast edges. Multiplying cost by a "
        "content-dependent factor rewards whichever candidate happens to "
        "sit on homogeneous sub-blocks with an UNDERESTIMATED cost, "
        "independent of its actual bits: on glyph/graphics content the "
        "ratios explode (zero-crossing counts on hard edges), candidates "
        "that should lose the argmin win it with costs scaled by wildly "
        "different factors, and the merge/split comparison is corrupted "
        "wholesale rather than refined. The effect is invisible on smooth "
        "families because all candidates' ratios (hence factors) are "
        "close, preserving the argmin order.",
        "",
        "Conclusion: against an encoder whose strategy search already "
        "evaluates every candidate's measured rate, homogeneity "
        "side-information is a constraint rather than a signal — these "
        "heuristics were proposed against libjxl's truncated heuristic "
        "search, where cheap side-information can patch what the search "
        "never evaluates; a dense search leaves them nothing to add, and "
        "the thesis-style summary.csv quantifies that on every grid "
        "point of every family.",
        "",
        "Artifacts: per-pair `summary.csv` + `comparison_diffs.csv` and "
        "per-strategy RD-curve/boxplot plots in the subdirectories.",
    ]
    with open(os.path.join(OUT, "README.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote", os.path.join(OUT, "README.md"))


if __name__ == "__main__":
    main()
