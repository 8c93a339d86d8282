"""Plotting — restores the graphing the Rust harness dropped.

The legacy pipeline drew seaborn boxplots of size-% grouped by effort,
faceted by distance (`old_test_jxl.py:372-417`); the Rust harness has no
graphing at all (SURVEY §2.5 notes the new framework should restore it).
This module adds those boxplots plus the thesis-style rate-distortion
curves (PSNR vs bpp per effort).
"""

from __future__ import annotations

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from jxl_jax.bench.csv_schema import comparison_result_from_row, read_csv_rows  # noqa: E402


def _load(path: str):
    _, rows = read_csv_rows(path)
    return [comparison_result_from_row(r) for r in rows]


def boxplot_size_percent(comparisons_csv: str, out_path: str, title: str = "") -> str:
    """Size-% of original grouped by effort, faceted by distance
    (`old_test_jxl.py:372-417` analog, dpi=300)."""
    results = _load(comparisons_csv)
    distances = sorted({r.distance for r in results})
    ncol = 3
    nrow = -(-len(distances) // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 3 * nrow), squeeze=False)
    for i, d in enumerate(distances):
        ax = axes[i // ncol][i % ncol]
        efforts = sorted({r.effort for r in results if r.distance == d})
        data = [
            [
                100.0 * r.comp_file_size / max(1, r.orig_file_size)
                for r in results
                if r.distance == d and r.effort == e
            ]
            for e in efforts
        ]
        ax.boxplot(data, tick_labels=[str(e) for e in efforts])
        ax.set_title(f"distance={d}")
        ax.set_xlabel("effort")
        ax.set_ylabel("size % of original")
    for j in range(len(distances), nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    fig.suptitle(title or os.path.basename(comparisons_csv))
    fig.tight_layout()
    fig.savefig(out_path, dpi=300)
    plt.close(fig)
    return out_path


def rd_curves(comparisons_csv: str, out_path: str, title: str = "") -> str:
    """PSNR vs bpp per effort — the thesis's rate-distortion view."""
    results = _load(comparisons_csv)
    efforts = sorted({r.effort for r in results})
    fig, ax = plt.subplots(figsize=(7, 5))
    for e in efforts:
        pts = sorted(
            (
                (8.0 * r.comp_file_size / max(1, r.orig_raw_size // 3), r.psnr)
                for r in results
                if r.effort == e
            ),
        )
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=f"e{e}")
    ax.set_xlabel("bits per pixel")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title or "rate-distortion")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=300)
    plt.close(fig)
    return out_path
