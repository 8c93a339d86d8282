"""End-to-end sweep harness tests: legacy decompress/compare stages +
resume semantics, on a tiny grid (CPU)."""

import csv
import os

import numpy as np
import pytest

from tests.conftest import make_test_image


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    from jxl_jax.core.io import write_image

    root = tmp_path_factory.mktemp("imgs")
    ts = root / "mini"
    ts.mkdir()
    for i in range(2):
        write_image(str(ts / f"im{i}.png"), make_test_image(32, 40, seed=i))
    return str(root)


def test_legacy_stages_write_tables_and_diffs(tiny_set, tmp_path):
    from jxl_jax.bench.sweep import (
        DECOMPRESSION_HEADER,
        SweepConfig,
        SweepRunner,
    )
    from jxl_jax.codec.config import Strategy

    cfg = SweepConfig(
        benchmark_dir=str(tmp_path / "bench"),
        test_image_dir=tiny_set,
        distances=(1.0, 3.0),
        efforts=(7,),
        decompress=True,
        compare_images=True,
    )
    runner = SweepRunner(cfg)
    rows = runner.run_test_set("mini", Strategy.BASELINE)
    assert len(rows) == 4  # 2 images x 2 distances

    base = os.path.join(runner.run_dir, "mini", "BASELINE")
    dec_csv = os.path.join(base, "results", "decompressed.csv")
    with open(dec_csv) as f:
        table = list(csv.reader(f))
    assert table[0] == DECOMPRESSION_HEADER  # old_test_jxl.py:133-158 parity
    assert len(table) == 5
    for row in table[1:]:
        assert os.path.exists(row[2])  # decompressed PNG on disk
        assert int(row[10]) > 0  # decompressed size
        # delta columns are consistent
        assert int(row[12]) == int(row[10]) - int(row[6])
        assert int(row[14]) == int(row[10]) - int(row[8])

    diffs = os.listdir(os.path.join(base, "diffs"))
    assert len(diffs) == 4 and all(d.endswith("-diff.png") for d in diffs)

    # higher distance decodes differ more: diff image has more energy
    from jxl_jax.core.io import read_image

    d1 = read_image(os.path.join(base, "diffs", "im0-1.0-7-diff.png"))
    d3 = read_image(os.path.join(base, "diffs", "im0-3.0-7-diff.png"))
    assert d3.astype(np.int64).sum() > d1.astype(np.int64).sum()


def test_sweep_resume_no_duplicate_rows(tiny_set, tmp_path):
    from jxl_jax.bench.sweep import SweepConfig, SweepRunner
    from jxl_jax.codec.config import Strategy

    cfg = SweepConfig(
        benchmark_dir=str(tmp_path / "bench2"),
        test_image_dir=tiny_set,
        distances=(1.0,),
        efforts=(7,),
    )
    runner = SweepRunner(cfg)
    runner.run_test_set("mini", Strategy.BASELINE)
    comp = runner.comparisons_csv("mini", Strategy.BASELINE)
    with open(comp) as f:
        n1 = len(f.readlines())
    # re-run in the same run dir: done-markers skip every point
    runner2 = SweepRunner(cfg, run_dir=runner.run_dir)
    rows2 = runner2.run_test_set("mini", Strategy.BASELINE)
    assert rows2 == []
    with open(comp) as f:
        assert len(f.readlines()) == n1
