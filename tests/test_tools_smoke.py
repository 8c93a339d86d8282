"""Smoke coverage for the measurement tools + the analysis API they use
: the tools must import cleanly (no private-symbol
imports from codec.encode) and the stable entry point must produce the
same token stream the real encoder codes."""

import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import make_test_image

TOOLS = [
    "ab_report",
    "batch_scaling",
    "bit_breakdown",
    "combo_study",
    "ctx_study",
    "epf_ab",
    "make_test_images",
    "modular_calib",
    "nnz_study",
    "rd_bound",
    "rd_point",
    "rd_position_corpus",
    "rd_position_report",
    "rd_tune",
    "route_ab",
]


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports(name):
    root = pathlib.Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    importlib.import_module(f"tools.{name}")


def test_no_private_stage1_imports_outside_codec():
    root = pathlib.Path(__file__).resolve().parents[1]
    offenders = []
    for p in list((root / "tools").glob("*.py")) + list(
        (root / "jxl_jax").rglob("*.py")
    ):
        for line in p.read_text().splitlines():
            if "import" in line and "_encode_stage1" in line:
                offenders.append(f"{p}: {line.strip()}")
    assert offenders == []


def test_analysis_entry_matches_encoder():
    from jxl_jax.codec.analysis import encode_tokens_for_analysis

    rgb = make_test_image(64, 96, seed=5)
    tok, nbits, mant, params, q_sorted = encode_tokens_for_analysis(
        rgb, 1.0, height=64, width=96, effort=3
    )
    from jxl_jax.codec.layout import token_layout

    assert tok.shape[0] == token_layout(64, 96)["n_tokens"]
    assert int(np.asarray(tok).max()) < 64


def test_route_ab_trace_reduction_on_cpu_trace(tmp_path):
    """tools/route_ab.scope_shares on a small recorded (CPU) trace of the
    encode program: the named rANS scopes get device time, within the
    module's total."""
    import glob

    import jax
    import jax.numpy as jnp

    from jxl_jax.codec.encode import _encode_full, pick_lanes
    from jxl_jax.codec.layout import padded_layout, token_layout
    from jxl_jax.entropy.tokens import byte_capacity
    from tools.route_ab import scope_shares

    h, w = 48, 64
    img = jnp.asarray(make_test_image(h, w, seed=2))
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], 256)
    kw = dict(
        height=h, width=w, effort=5, hook_a=False, hook_b=False, lanes=lanes,
        cap_bytes=byte_capacity(padded_layout(h, w, lanes)["n_padded"]),
    )
    hlo = _encode_full.lower(img, jnp.float32(1.0), **kw).compile().as_text()
    jax.block_until_ready(_encode_full(img, jnp.float32(1.0), **kw))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(_encode_full(img, jnp.float32(1.0), **kw))
    xp = glob.glob(str(tmp_path / "plugins/profile/*/*.xplane.pb"))[0]
    scopes = ("rans_encode_scan", "rans_word_scatter", "mantissa_pack")
    out = scope_shares(xp, hlo, "_encode_full", scopes, device_prefix="/host:CPU")
    assert out["busy_ns"] > 0
    assert 0 < out["share"]["rans_encode_scan"] <= 1
    assert sum(out["by_scope"].values()) <= out["busy_ns"]


def test_union_of_nested_intervals():
    from tools.route_ab import _union_ns

    assert _union_ns([]) == 0
    # a command buffer [0, 10) holding kernels [1, 3) and [2, 5); then [12, 13)
    assert _union_ns([(1, 3), (0, 10), (2, 5), (12, 13)]) == 11
