"""The GPU rANS decode kernel (entropy/triton_rans.py) against its plain
reference, the XLA scan twin grouped.decode_grouped: bit for bit (rANS
states, stream pointers and symbols are integers — the tolerance is zero).

On the CPU the kernel runs under the Pallas interpreter. The `gpu` tests
run the compiled kernel; they skip elsewhere and `python chip_smoke.py`
runs them in-process on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jxl_jax.entropy.grouped import (
    GROUP,
    MANT_SLACK,
    WORD_SLACK,
    decode_grouped,
    kernel_rows,
    pack_mantissa_grouped,
    rans_encode_grouped,
)
from jxl_jax.entropy.rans import quantize_histograms
from jxl_jax.entropy.tokens import tokenize
from jxl_jax.entropy.triton_rans import decode_grouped_triton, decode_route

T_SMALL = 8  # scan steps: phase A takes the first 3, phase B the rest
T_A = 3


def _streams(lanes: int, B: int, T: int = T_SMALL):
    """B independently coded streams of one geometry, laid out as the
    batched kernel takes them, plus the values they encode."""
    G = lanes // GROUP
    step_ctx = (np.arange(T) * 3 // T).astype(np.int32)  # 3 contexts
    enc, vals_all = [], []
    for b in range(B):
        rng = np.random.default_rng(100 * lanes + b)
        vals = rng.geometric(0.15 + 0.1 * b, size=T * lanes).astype(np.uint32) - 1
        vals[rng.random(vals.size) < 0.04] += 300 + (1 << 17) * (b % 2)
        token, nbits, mant = map(np.asarray, tokenize(jnp.asarray(vals)))
        counts = np.zeros((3, 52), np.int64)
        np.add.at(counts, (np.repeat(step_ctx, lanes), token), 1)
        freq, cum = (jnp.asarray(x) for x in quantize_histograms(counts))
        words, wcounts, states = map(
            np.asarray,
            rans_encode_grouped(
                jnp.asarray(token.astype(np.int32)), jnp.asarray(step_ctx), freq, cum, lanes
            ),
        )
        mbytes, mcounts = map(
            np.asarray,
            pack_mantissa_grouped(jnp.asarray(nbits), jnp.asarray(mant), lanes, T * lanes * 3),
        )
        rows = np.asarray(kernel_rows(jnp.asarray(step_ctx), freq, cum))
        enc.append((words, wcounts, states, mbytes, mcounts, rows))
        vals_all.append(vals)
    capw = max(int(e[1].max()) for e in enc) + WORD_SLACK
    capm = max(int(e[4].max()) for e in enc) + MANT_SLACK
    wg = np.zeros((B * G, capw), np.uint32)
    mg = np.zeros((B * G, capm), np.uint32)
    for b, (words, wcounts, _s, mbytes, mcounts, _r) in enumerate(enc):
        wb = np.concatenate([[0], np.cumsum(wcounts)])
        mb = np.concatenate([[0], np.cumsum(mcounts)])
        for g in range(G):
            wg[b * G + g, : wcounts[g]] = words[wb[g] : wb[g + 1]]
            mg[b * G + g, : mcounts[g]] = mbytes[mb[g] : mb[g + 1]]
    states = np.stack([e[2] for e in enc]).reshape(B * G, GROUP)
    rows = np.stack([e[5] for e in enc], axis=1)  # [T, B, 128]
    return wg, mg, states, rows, np.stack(vals_all)


def _check_against_reference(lanes: int, B: int, interpret: bool):
    """Two-phase kernel decode (carry A -> B) must equal the twin's values,
    final states and both stream pointers of every group, and the input."""
    G = lanes // GROUP
    wg, mg, states, rows, vals = _streams(lanes, B)
    kw = dict(lanes=lanes, interpret=interpret)
    va, sa, pa = decode_grouped_triton(wg, mg, states, rows[:T_A], T=T_A, **kw)
    vb, sb, pb = decode_grouped_triton(
        wg, mg, sa, rows[T_A:], T=T_SMALL - T_A, ptr_init=pa, **kw
    )
    va, sa, pa, vb, sb, pb = jax.device_get((va, sa, pa, vb, sb, pb))
    np.testing.assert_array_equal(np.concatenate([va, vb], axis=1), vals)
    for b in range(B):
        g = slice(b * G, (b + 1) * G)
        ra = decode_grouped(
            wg[g], mg[g], states[g].reshape(-1), rows[:T_A, b], T=T_A, lanes=lanes,
            return_carry=True,
        )
        rb = decode_grouped(
            wg[g], mg[g], ra[1], rows[T_A:, b], T=T_SMALL - T_A, lanes=lanes,
            gptr0=ra[2], bptr0=ra[3], return_carry=True,
        )
        for (v, x, gp, bp), (kv, kx, kp) in ((ra, (va, sa, pa)), (rb, (vb, sb, pb))):
            np.testing.assert_array_equal(np.asarray(v), kv[b])
            np.testing.assert_array_equal(np.asarray(x).reshape(G, GROUP), kx[g])
            np.testing.assert_array_equal(np.asarray(gp), kp[0, g])
            np.testing.assert_array_equal(np.asarray(bp), kp[1, g])


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("lanes", [128, 256, 512])
def test_kernel_interpret_matches_reference(lanes, B):
    _check_against_reference(lanes, B, interpret=True)


# Forged streams: the kernel's gathers must stay in each group's segment
# and agree with the twin's clamped dynamic_slice windows, whatever the
# states and pointers say.
FORGED = {  # states: every lane's; ptr(capw, capm): every other group's
    "renorm_every_step": dict(states=1),  # x < L: a word per lane per step
    "zero_states": dict(states=0),
    "pointers_past_end": dict(ptr=lambda cw, cm: (1 << 20, 1 << 20)),
    "negative_pointers": dict(ptr=lambda cw, cm: (-700, -700)),
    "last_element_and_renorm": dict(states=1, ptr=lambda cw, cm: (cw - 1, cm - 1)),
}


def _check_forged(case: str, lanes: int, interpret: bool):
    G = lanes // GROUP
    B = 2
    wg, mg, states, rows, _vals = _streams(lanes, B)
    forge = FORGED[case]
    if "states" in forge:
        states = np.full_like(states, forge["states"])
    ptr = np.zeros((2, B * G), np.int32)
    if "ptr" in forge:
        ptr[0, ::2], ptr[1, ::2] = forge["ptr"](wg.shape[1], mg.shape[1])
    v, x, p = jax.device_get(
        decode_grouped_triton(
            wg, mg, states, rows, T=T_SMALL, lanes=lanes, ptr_init=jnp.asarray(ptr),
            interpret=interpret,
        )
    )
    for b in range(B):
        g = slice(b * G, (b + 1) * G)
        rv, rx, rg, rb = decode_grouped(
            wg[g], mg[g], states[g].reshape(-1), rows[:, b], T=T_SMALL, lanes=lanes,
            gptr0=jnp.asarray(ptr[0, g]), bptr0=jnp.asarray(ptr[1, g]), return_carry=True,
        )
        np.testing.assert_array_equal(np.asarray(rv), v[b])
        np.testing.assert_array_equal(np.asarray(rx).reshape(G, GROUP), x[g])
        np.testing.assert_array_equal(np.asarray(rg), p[0, g])
        np.testing.assert_array_equal(np.asarray(rb), p[1, g])


@pytest.mark.parametrize("case", sorted(FORGED))
def test_kernel_interpret_forged_streams_match_reference(case):
    _check_forged(case, 256, interpret=True)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU: the compiled Triton kernel has no CPU lowering")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("lanes", [128, 256, 512])
def test_kernel_compiled_matches_reference(gpu, lanes, B):
    _check_against_reference(lanes, B, interpret=False)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [256, 512])
@pytest.mark.parametrize("case", sorted(FORGED))
def test_kernel_compiled_forged_streams_match_reference(gpu, case, lanes):
    _check_forged(case, lanes, interpret=False)


def _fuzzed_containers(n_flips: int):
    """test_fuzz's corruptions of one small lossy container: random byte
    flips, and the rANS states forged to 1 (a renormalization on every
    step, so the word pointers run far past the stream)."""
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.container import read_container, write_container
    from jxl_jax.codec.encode import encode_image

    # built here, not imported: on the card's machine another installed
    # `tests` package can shadow this directory's conftest
    r = np.random.default_rng(3)
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1) + r.integers(0, 24, (48, 64, 3))
    data = encode_image(np.clip(img, 0, 255).astype(np.uint8), CodecConfig(distance=2.0, effort=3))
    s = read_container(data)
    s.states = np.ones_like(s.states)
    out = {"forged_states": write_container(s)}
    r = np.random.default_rng(12)
    for i in range(n_flips):
        mut = bytearray(data)
        mut[int(r.integers(0, len(data)))] ^= 1 << int(r.integers(0, 8))
        out[f"flip{i}"] = bytes(mut)
    return out


def _check_fuzzed(route: str, n_flips: int):
    """Each corrupt container either is rejected cleanly (ValueError) or
    has its rANS stage decoded by `route` exactly as by the twin."""
    from jxl_jax.codec.decode import decode_rans_row

    decoded = 0
    for name, data in _fuzzed_containers(n_flips).items():
        try:
            ref = decode_rans_row([data], "xla")
        except ValueError:
            continue
        got = decode_rans_row([data], route)
        for x, y in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(x, y, err_msg=name)
        decoded += 1
    assert decoded > 0


def test_fuzzed_containers_interpret_match_xla():
    _check_fuzzed("interpret", n_flips=2)


@pytest.mark.gpu
def test_fuzzed_containers_compiled_match_xla(gpu):
    """test_fuzz's byte-flip and forged-state cases on the compiled kernel:
    the twin's values, and decode_bytes still returns an image."""
    from jxl_jax.codec.decode import decode_bytes

    _check_fuzzed("triton", n_flips=40)
    for data in _fuzzed_containers(40).values():
        try:
            out = decode_bytes(data)
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.shape[2] == 3


@pytest.mark.gpu
def test_decode_route_on_gpu_is_kernel(gpu):
    from jxl_jax.codec.decode import _route

    assert _route() == "triton"


@pytest.mark.parametrize(
    "platform, route", [("gpu", "triton"), ("cpu", "xla"), ("rocm", None), ("METAL", None)]
)
def test_decode_route_by_platform(platform, route):
    if route is None:
        with pytest.raises(ValueError, match="no rANS decode route"):
            decode_route(platform)
    else:
        assert decode_route(platform) == route


def test_decode_route_default_is_this_device():
    assert decode_route() == "xla"  # the tests run on the CPU


def test_kernel_without_ptr_init_starts_at_zero():
    """ptr_init=None is the same as explicit zero pointers."""
    wg, mg, states, rows, vals = _streams(128, 1)
    a = decode_grouped_triton(wg, mg, states, rows, T=T_SMALL, lanes=128, interpret=True)
    b = decode_grouped_triton(
        wg, mg, states, rows, T=T_SMALL, lanes=128, interpret=True,
        ptr_init=jnp.zeros((2, 1), jnp.int32),
    )
    for x, y in zip(jax.device_get(a), jax.device_get(b)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jax.device_get(a[0]), vals)


@pytest.fixture(scope="module")
def grid_row():
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.encode import encode_image_grid
    from tests.conftest import make_test_image

    img = make_test_image(40, 56, seed=3)
    return img, encode_image_grid(img, CodecConfig(effort=5), [0.7, 1.5, 3.0])


def test_grid_row_rans_interpret_matches_xla(grid_row):
    """decode_rans_row: the whole two-phase rANS stage of a grid row
    (phase-B contexts from the decoded nnz map) on both routes."""
    from jxl_jax.codec.decode import decode_rans_row

    a = jax.tree_util.tree_leaves(decode_rans_row(grid_row[1], "xla"))
    b = jax.tree_util.tree_leaves(decode_rans_row(grid_row[1], "interpret"))
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_grid_row_pixels_interpret_match_xla(grid_row):
    """The batched kernel path of _decode_packed_grid gives the same pixels
    as the per-image twin path, and as decode_bytes of each container."""
    from jxl_jax.codec.decode import _decode_packed_grid, _pack_row, decode_bytes

    packed, dists, kw = _pack_row(grid_row[1])
    args = (jnp.asarray(packed), jnp.asarray(dists))
    px_xla = np.asarray(_decode_packed_grid(*args, epf=True, route="xla", **kw))
    px_k = np.asarray(_decode_packed_grid(*args, epf=True, route="interpret", **kw))
    np.testing.assert_array_equal(px_k, px_xla)
    np.testing.assert_array_equal(px_k[1], decode_bytes(grid_row[1][1]))
