import os

from jxl_jax.bench.csv_schema import (
    COMPARISON_DIFF_HEADER,
    COMPARISON_RESULT_HEADER,
    IMAGE_FILE_DATA_HEADER,
    ComparisonResult,
    append_rows,
    comparison_result_from_row,
    find_entry,
    read_csv_rows,
    write_csv_header,
)
from jxl_jax.core.image import ColorType, ImageFileData, ImageFormat


def test_headers_match_reference_schema():
    assert len(IMAGE_FILE_DATA_HEADER) == 13
    assert len(COMPARISON_RESULT_HEADER) == 17
    assert len(COMPARISON_DIFF_HEADER) == 17
    assert COMPARISON_RESULT_HEADER[10] == "MSE"
    assert COMPARISON_RESULT_HEADER[15] == "Butteraugli 3-Norm"
    assert COMPARISON_DIFF_HEADER[4] == "Diff Original File Size"


def test_idempotent_header_and_append(tmp_path):
    p = str(tmp_path / "results.csv")
    write_csv_header(p, COMPARISON_RESULT_HEADER)
    write_csv_header(p, COMPARISON_RESULT_HEADER)  # second call is a no-op
    r = ComparisonResult(
        orig_image_name="a.png",
        comp_image_name="a-1.0-7.jxt",
        distance=1.0,
        effort=7,
        orig_file_size=1000,
        comp_file_size=100,
        psnr=40.0,
    )
    append_rows(p, [r.row()])
    header, rows = read_csv_rows(p)
    assert header == COMPARISON_RESULT_HEADER
    assert len(rows) == 1
    back = comparison_result_from_row(rows[0])
    assert back.orig_image_name == "a.png"
    assert back.psnr == 40.0
    assert back.effort == 7


def test_find_entry(tmp_path):
    p = str(tmp_path / "results.csv")
    write_csv_header(p, COMPARISON_RESULT_HEADER)
    for i in range(3):
        append_rows(p, [ComparisonResult(orig_image_name=f"img{i}.png").row()])
    row = find_entry(p, "Original Image Name", "img1.png")
    assert row is not None and row[0] == "img1.png"
    assert find_entry(p, "Original Image Name", "nope.png") is None


def test_image_file_data_csv_row():
    d = ImageFileData(
        image_name="x.png",
        commit="BASELINE",
        test_set="kodak",
        file_path="/tmp/x.png",
        width=10,
        height=20,
        file_size=123,
        raw_size=600,
        color_space=ColorType.Rgb8,
        format=ImageFormat.Png,
    )
    row = d.csv_row()
    assert len(row) == len(IMAGE_FILE_DATA_HEADER)
    assert row[-3:] == ["", "", ""]  # empty JXL fields round-trip as blanks
