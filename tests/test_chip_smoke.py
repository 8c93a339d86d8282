"""chip_smoke.py on the CPU: it refuses to run without a GPU or outside a
checkout, and its phases (the codec's main path) work at tiny sizes, with
the rANS kernel under the Pallas interpreter."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SMALL = (64, 64)


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _no_result_line(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return not json.loads(lines[-1]).get("ok")
    except (ValueError, AttributeError):
        return True


def test_exits_nonzero_without_gpu():
    p = _run_script(ROOT, ROOT / "chip_smoke.py")
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    assert _no_result_line(p.stdout)


def test_exits_nonzero_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run_script(tmp_path, tmp_path / "chip_smoke.py")
    assert p.returncode != 0
    assert _no_result_line(p.stdout)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("smoke"))


@pytest.fixture(scope="module")
def codec(work):
    return cs.phase_codec(work, shape=SMALL, band=(25.0, 80.0))


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.phase_device()
    assert cs.phase_device(require_gpu=False)["platform"] == "cpu"


def test_phase_codec(codec):
    assert codec["bytes"] == len(codec["_data"]) > 0
    assert 25.0 <= codec["psnr_db"] <= 80.0


def test_phase_codec_band_is_enforced(work):
    with pytest.raises(AssertionError, match="outside"):
        cs.phase_codec(work, shape=SMALL, band=(90.0, 99.0))


def test_phase_grid(codec):
    out = cs.phase_grid(codec["_rgb"], n=3)
    assert out["points"] == 3 and out["psnr_db"] > 25.0


def test_phase_large_small_shape():
    out = cs.phase_large(shape=(48, 80), expect_lanes=128)
    assert out["lanes"] == 128
    with pytest.raises(AssertionError, match="lanes"):
        cs.phase_large(shape=(48, 80), expect_lanes=512)


def test_phase_lossless(codec):
    out = cs.phase_lossless(codec["_rgb"])
    assert out["exact"] and out["modular_psnr_db"] > 30.0
    assert "JXL_JAX_MODULAR" not in os.environ  # knobs restored


def test_phase_sweep(work):
    out = cs.phase_sweep(work, shape=(48, 64), distances=(1.0, 4.0))
    assert out["points"] == 4
    assert (out["results_cols"], out["comparisons_cols"]) == (13, 17)


def test_phase_server(work, codec):
    out = cs.phase_server(work, codec["_png"])
    assert out["ping"] == "pong"
    assert set(out) == {"ping", "encode", "decode"}


def test_phase_kernel_interpret(codec):
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.encode import encode_image_grid

    row = encode_image_grid(codec["_rgb"], CodecConfig(effort=7), [0.5, 2.0, 8.0])
    out = cs.phase_kernel({"single": [codec["_data"]], "row": row}, route="interpret")
    assert out["route"] == "interpret"
    assert out["row"]["images"] == 3 and out["single"]["equal"]


def test_phase_multi_on_virtual_devices():
    out = cs.phase_multi(n_images=4, shape=(32, 48), n_devices=4)
    assert out["mesh"] == {"data": 4, "space": 1}
    assert out["bytes_equal"] == out["containers"] == 4 + 4 * 2
