"""Smoke run of the codec's main path on one GPU, through the entry points a
user calls, at the sizes users run.

  python chip_smoke.py           # one GPU: every phase below
  python chip_smoke.py --multi   # four GPUs: the sharded encode path only

Phases (one result line each, wall time including compilation):

  device    jax.devices(), device_kind, nvidia-smi name and power limit
  codec     encode_file/decode_file of a Kodak-shaped 512x768 image at
            d=1 e7: bytes, bpp, PSNR inside the CPU run's band
  grid      a grid row of 32 points at d=1 e7 through encode_image_grid +
            decode_bytes_grid_stacked
  large     a CLIC-sized 2048x1365 image (rANS lanes auto-grow to 512)
  lossless  d=0 with exact pixel equality, and a modular-lossy round trip
  sweep     `jxl_jax bench` in-process over 2 images x d in {0.5,1,2,4,8}
            x e7, then the 13- and 17-column CSVs (bench/csv_schema.py)
  server    `serve` in a thread of this process; ping, encode and decode
            through try_forward
  kernel    the Triton rANS decode kernel against its XLA twin on the
            card, bit for bit: lanes 256 and 512, both scan phases with
            their carry, and a batched grid row of 32
  gpu-tests the tests marked `gpu`, in-process (pytest.main)

The first failing phase ends the run with its traceback and a non-zero
exit; no phase catches its own failure. The last line is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}. Without a GPU, or
outside a checkout of the repository, the script exits non-zero before
any phase. Everything runs in this one process: a JAX process reserves
most of a card's memory, so a second one on the card would fail.

Images are synthesized from seeds by tools/make_test_images.py.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

KODAK = (512, 768)  # Kodak Lossless True Color shape
LARGE = (1365, 2048)  # CLIC-sized
GRID_N = 32
SWEEP_DISTANCES = (0.5, 1.0, 2.0, 4.0, 8.0)
SEED = 0
# encode_file -> decode_file of synth_photo(512, 768, seed=0) at d=1 e7 on
# the CPU (XLA's CPU backend, same code): the GPU run must land in this
# PSNR band. Encoder decisions (ACS, RDO, EPF, mode picks) are discrete
# choices on floats, so the card's bytes may differ from the CPU's.
KODAK_CPU_PSNR = 40.01817087889259
KODAK_CPU_BYTES = 57684
KODAK_CPU_SHA256 = "a24d4026c8c96635fb0abc38be8f999e67ed91c33160089e02dd0ceefd15ee96"
PSNR_BAND_DB = 0.25


def _log(msg: str) -> None:
    print(msg, flush=True)


def _run(name: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    shown = {k: v for k, v in out.items() if not k.startswith("_")}
    _log(f"[{name}] {json.dumps(shown)} ({time.perf_counter() - t0:.1f} s)")
    return out


def _images():
    sys.path.insert(0, ROOT)
    from tools.make_test_images import synth_graphics, synth_photo

    return synth_photo, synth_graphics


def _psnr(a, b) -> float:
    from jxl_jax.metrics.quality import calculate_psnr

    return float(calculate_psnr(a, b))


def phase_device(require_gpu: bool = True) -> dict:
    import jax

    devs = jax.devices()
    info = {
        "devices": [str(d) for d in devs],
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if require_gpu and info["platform"] != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {info['platform']!r}")
    if info["platform"] == "gpu":
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    return info


def phase_codec(work: str, shape=KODAK, seed: int = SEED, band=None) -> dict:
    """encode_file/decode_file at d=1 e7; band = (lo, hi) PSNR dB."""
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_file
    from jxl_jax.codec.encode import encode_file
    from jxl_jax.core.io import write_image

    synth_photo, _ = _images()
    rgb = synth_photo(*shape, seed)
    png, jxt = os.path.join(work, "kodak.png"), os.path.join(work, "kodak.jxt")
    write_image(png, rgb)
    size = encode_file(png, jxt, CodecConfig(distance=1.0, effort=7))
    out = decode_file(jxt)
    psnr = _psnr(rgb, out)
    with open(jxt, "rb") as f:
        data = f.read()
    if band is None:
        band = (KODAK_CPU_PSNR - PSNR_BAND_DB, KODAK_CPU_PSNR + PSNR_BAND_DB)
    if out.shape != rgb.shape or not band[0] <= psnr <= band[1]:
        raise AssertionError(f"codec: shape {out.shape}, PSNR {psnr:.3f} dB outside {band}")
    sha = hashlib.sha256(data).hexdigest()
    return {
        "bytes": size, "bpp": size * 8 / (shape[0] * shape[1]), "psnr_db": psnr,
        "cpu_psnr_db": KODAK_CPU_PSNR, "cpu_bytes": KODAK_CPU_BYTES,
        "bytes_equal_cpu": sha == KODAK_CPU_SHA256,
        "_rgb": rgb, "_data": data, "_png": png,
    }


def phase_grid(rgb, n: int = GRID_N) -> dict:
    """A grid row of n points at d=1 e7 (bench.py's configuration)."""
    import jax
    import numpy as np

    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes, decode_bytes_grid_stacked
    from jxl_jax.codec.encode import encode_image_grid

    datas = encode_image_grid(rgb, CodecConfig(distance=1.0, effort=7), [1.0] * n)
    px = np.asarray(jax.device_get(decode_bytes_grid_stacked(datas)))
    if px.shape != (n, *rgb.shape):
        raise AssertionError(f"grid: decoded shape {px.shape}")
    first, last = px[0], px[n - 1]
    if not ((first == decode_bytes(datas[0])).all() and (last == first).all()):
        raise AssertionError("grid: stacked decode differs from the per-stream decode")
    return {"points": n, "bytes": len(datas[0]), "psnr_db": _psnr(rgb, first)}


def phase_large(shape=LARGE, expect_lanes: int | None = 512, seed: int = SEED + 1) -> dict:
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.container import read_container
    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.codec.encode import encode_image

    synth_photo, _ = _images()
    rgb = synth_photo(*shape, seed)
    data = encode_image(rgb, CodecConfig(distance=1.0, effort=7))
    lanes = read_container(data).header.lanes
    psnr = _psnr(rgb, decode_bytes(data))
    if expect_lanes is not None and lanes != expect_lanes:
        raise AssertionError(f"large: {lanes} lanes, expected {expect_lanes}")
    if not psnr > 30.0:
        raise AssertionError(f"large: PSNR {psnr:.2f} dB")
    return {"shape": list(shape), "lanes": lanes, "bytes": len(data), "psnr_db": psnr,
            "_data": data}


def phase_lossless(rgb) -> dict:
    """d=0 exactly; then modular-lossy, forced by the codec's A/B knobs
    (JXL_JAX_MODULAR=2 dispatches the modular path, JXL_JAX_MOD_RULE makes
    the measured mode decision keep it)."""
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.container import read_container
    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.codec.encode import encode_image

    data = encode_image(rgb, CodecConfig(distance=0.0))
    if not (decode_bytes(data) == rgb).all():
        raise AssertionError("lossless: pixels differ after a d=0 round trip")
    knobs = {"JXL_JAX_MODULAR": "2", "JXL_JAX_MOD_RULE": "1e9,1e9,0,0"}
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        mod = encode_image(rgb, CodecConfig(distance=1.0, effort=7))
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    if not read_container(mod).header.lossless:
        raise AssertionError("modular-lossy: container is not modular")
    psnr = _psnr(rgb, decode_bytes(mod))
    if not psnr > 30.0:
        raise AssertionError(f"modular-lossy: PSNR {psnr:.2f} dB")
    return {"lossless_bytes": len(data), "exact": True, "modular_bytes": len(mod),
            "modular_psnr_db": psnr}


def phase_sweep(work: str, shape=KODAK, distances=SWEEP_DISTANCES) -> dict:
    """`python -m jxl_jax bench` in-process, then the CSV schemas."""
    import csv

    from jxl_jax.bench.csv_schema import COMPARISON_RESULT_HEADER, IMAGE_FILE_DATA_HEADER
    from jxl_jax.cli.main import main
    from jxl_jax.core.io import write_image

    synth_photo, synth_graphics = _images()
    imgs = os.path.join(work, "sweep_images")
    os.makedirs(os.path.join(imgs, "smoke"), exist_ok=True)
    write_image(os.path.join(imgs, "smoke", "photo.png"), synth_photo(*shape, SEED + 2))
    write_image(os.path.join(imgs, "smoke", "graphics.png"), synth_graphics(*shape, SEED + 3))
    bench = os.path.join(work, "sweep_out")
    rc = main([
        "bench", "--test-image-dir", imgs, "--benchmark-dir", bench,
        "--distances", *map(str, distances), "--efforts", "7",
    ])
    if rc != 0:
        raise AssertionError(f"sweep: bench exited {rc}")
    res_dir = os.path.join(bench, "0", "smoke", "BASELINE", "results")
    tables = {}
    for name, header in (("results.csv", IMAGE_FILE_DATA_HEADER),
                         ("comparisons.csv", COMPARISON_RESULT_HEADER)):
        with open(os.path.join(res_dir, name), newline="") as f:
            rows = list(csv.reader(f))
        if rows[0] != header or any(len(r) != len(header) for r in rows[1:]):
            raise AssertionError(f"sweep: {name} does not follow its {len(header)}-column schema")
        tables[name] = rows
    comps = tables["comparisons.csv"]
    n_points = 2 * len(distances)
    psnr_col = COMPARISON_RESULT_HEADER.index("PSNR")
    psnrs = [float(r[psnr_col]) for r in comps[1:]]
    if len(comps) - 1 != n_points or not all(p == p and p > 10.0 for p in psnrs):
        raise AssertionError(f"sweep: {len(comps) - 1} comparison rows, PSNRs {psnrs}")
    return {"points": n_points, "results_cols": len(IMAGE_FILE_DATA_HEADER),
            "comparisons_cols": len(COMPARISON_RESULT_HEADER),
            "psnr_db_range": [min(psnrs), max(psnrs)]}


def phase_server(work: str, png: str) -> dict:
    """The persistent server in a thread of this process (one process on
    the card), driven through the CLI's forwarding client."""
    from jxl_jax.cli.server import serve, try_forward

    sock = os.path.join(work, "jxl.sock")
    th = threading.Thread(target=serve, args=(sock,), kwargs={"warm": False}, daemon=True)
    th.start()
    deadline = time.time() + 60
    while not os.path.exists(sock):
        if time.time() > deadline or not th.is_alive():
            raise AssertionError("server: socket never appeared")
        time.sleep(0.05)
    jxt, back = os.path.join(work, "srv.jxt"), os.path.join(work, "srv.png")
    replies = {
        "ping": try_forward({"cmd": "ping"}, socket_path=sock),
        "encode": try_forward({"cmd": "encode", "input": png, "output": jxt,
                               "distance": 1.0, "effort": 7}, socket_path=sock),
        "decode": try_forward({"cmd": "decode", "input": jxt, "output": back},
                              socket_path=sock),
    }
    try_forward({"cmd": "shutdown"}, socket_path=sock)
    th.join(timeout=30)
    bad = {k: v for k, v in replies.items() if not (v and v.get("ok"))}
    if bad:
        raise AssertionError(f"server: {bad}")
    return {k: v["msg"] for k, v in replies.items()}


def phase_kernel(cases: dict, route: str | None = None) -> dict:
    """The rANS stage (both scan phases, carry included) of each case's
    containers on the kernel route vs the XLA twin: values, final states
    and stream pointers must be equal (integers: zero tolerance)."""
    import jax
    import numpy as np

    from jxl_jax.codec.container import read_container
    from jxl_jax.codec.decode import decode_rans_row
    from jxl_jax.entropy.triton_rans import decode_route

    route = route or decode_route()
    out = {"route": route}
    for name, datas in cases.items():
        k = jax.tree_util.tree_leaves(decode_rans_row(datas, route))
        x = jax.tree_util.tree_leaves(decode_rans_row(datas, "xla"))
        if len(k) != len(x) or not all(np.array_equal(a, b) for a, b in zip(k, x)):
            raise AssertionError(f"kernel: {name} differs from the XLA twin")
        out[name] = {"images": len(datas), "lanes": read_container(datas[0]).header.lanes,
                     "values": int(k[0].size), "equal": True}
    return out


def phase_gpu_tests() -> dict:
    """The `gpu`-marked tests, in this process (never a second process on
    the card): conftest.py leaves the platform alone under
    CHIP_SMOKE_IN_PROCESS, and addopts (xdist workers) is cleared."""
    import pytest

    os.environ["CHIP_SMOKE_IN_PROCESS"] = "1"
    rc = pytest.main([
        "-q", "-o", "addopts=", "-p", "no:cacheprovider", "-m", "gpu",
        os.path.join(ROOT, "tests", "test_triton_kernel.py"),
    ])
    if rc != 0:
        raise AssertionError(f"gpu tests: pytest exited {int(rc)}")
    return {"pytest_exit": int(rc)}


def phase_multi(n_images: int = 8, shape=KODAK, n_devices: int = 4) -> dict:
    """Corpus data parallelism over a data=n, space=1 mesh: the sharded
    batch and grid encoders against the single-card encode of the same
    images — bytes first, then decoded PSNR where bytes differ."""
    from dataclasses import replace

    import jax

    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.codec.encode import encode_image
    from jxl_jax.distributed.mesh import make_mesh
    from jxl_jax.distributed.sharded import encode_batch_sharded, encode_grid_sharded

    if len(jax.devices()) < n_devices:
        raise SystemExit(f"--multi needs {n_devices} devices; JAX found {len(jax.devices())}")
    synth_photo, _ = _images()
    imgs = [synth_photo(*shape, 10 + i) for i in range(n_images)]
    cfg = CodecConfig(distance=1.0, effort=7)
    mesh = make_mesh(n_devices, data=n_devices, space=1)
    dists = [1.0, 2.0]
    t0 = time.perf_counter()
    batch = encode_batch_sharded(imgs, cfg, mesh=mesh)
    grid = encode_grid_sharded(imgs, cfg, dists, mesh=mesh)
    t_sharded = time.perf_counter() - t0
    # single card: encode_image per (image, distance); the grid path is
    # byte-identical to it, so one compiled program serves both checks
    t0 = time.perf_counter()
    single = [[encode_image(im, replace(cfg, distance=d)) for d in dists] for im in imgs]
    t_single = time.perf_counter() - t0
    pairs = [(b, s[0], im) for b, s, im in zip(batch, single, imgs)]
    pairs += [(g, s, im) for gs, ss, im in zip(grid, single, imgs) for g, s in zip(gs, ss)]
    n_equal = sum(a == b for a, b, _ in pairs)
    deltas = [
        _psnr(im, decode_bytes(a)) - _psnr(im, decode_bytes(b))
        for a, b, im in pairs if a != b
    ]
    if deltas and max(abs(d) for d in deltas) > 0.1:
        raise AssertionError(f"multi: sharded PSNR differs from single-card by {deltas}")
    return {"mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
            "containers": len(pairs), "bytes_equal": n_equal,
            "max_abs_psnr_delta_db": max((abs(d) for d in deltas), default=0.0),
            "sharded_s_incl_compile": t_sharded, "single_s_incl_compile": t_single}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: run only the sharded encode path and its comparison")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "jxl_jax")):
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, ROOT)

    dev = _run("device", phase_device)
    if args.multi:
        _run("multi", phase_multi)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            codec = _run("codec", phase_codec, work)
            _run("grid", phase_grid, codec["_rgb"])
            large = _run("large", phase_large)
            _run("lossless", phase_lossless, codec["_rgb"])
            _run("sweep", phase_sweep, work)
            _run("server", phase_server, work, codec["_png"])
            import numpy as np

            from jxl_jax.codec.config import CodecConfig
            from jxl_jax.codec.encode import encode_image_grid

            row = encode_image_grid(
                codec["_rgb"], CodecConfig(effort=7), list(np.geomspace(0.5, 8.0, GRID_N))
            )
            _run("kernel", phase_kernel, {
                "kodak_lanes256": [codec["_data"]],
                "large_lanes512": [large["_data"]],
                "grid_row_32": row,
            })
        _run("gpu-tests", phase_gpu_tests)
    import jax

    _log(f"card: {dev['nvidia_smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
