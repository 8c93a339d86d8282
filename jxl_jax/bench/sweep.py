"""Rate-distortion sweep driver — the `JXLCompressionBenchmark` analog.

Reproduces the reference's benchmark semantics (`benchmark.rs:576-714`):
for each image of each test set, sweep the distance x effort grid, record a
13-col metadata row per file and a 17-col ComparisonResult row per grid
point. Differences, by design (SURVEY §5, §7):

- Codec variants are `Strategy` flags, not git commits: no per-dispatch
  libjxl rebuild (the reference rebuilds C++ per dispatched image,
  `benchmark.rs:479-484` — its dominant cost).
- Sweep grids are config, not hardcoded (the reference TODOs this at
  `benchmark.rs:636-638`); both reference grids ship as presets.
- Run numbering: `benchmarks/<n>/` with n = max+1 (`benchmark.rs:280-302`).
- Resumable: a per-(image, d, e) done-marker set lets an interrupted sweep
  continue (SURVEY §5.4 calls this out as missing in the reference).
- Encode/decode/metric-battery wall time and MP/s are recorded per grid
  point in `timings.csv` (the reference never measures timing — SURVEY
  §5.1); the 17-col comparisons.csv stays byte-compatible.
- Single-writer CSV appends (the reference's concurrent appends race,
  SURVEY §5.2).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from jxl_jax.bench.csv_schema import (
    COMPARISON_RESULT_HEADER,
    IMAGE_FILE_DATA_HEADER,
    ComparisonResult,
    append_rows,
    write_csv_header,
)
from jxl_jax.codec.config import CodecConfig, Strategy
from jxl_jax.codec.decode import decode_bytes_grid_device
from jxl_jax.codec.encode import encode_image, encode_image_grid
from jxl_jax.core.io import read_image, read_image_metadata
from jxl_jax.metrics import file_size_ratio
from jxl_jax.metrics.battery import metric_battery_async

# Reference sweep grids:
# Rust harness (`benchmark.rs:637-638`)
RUST_DISTANCES = (0.5, 1.0, 1.5, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0)
RUST_EFFORTS = (5, 6, 7, 8, 9)
# Legacy python pipeline (`old_test_jxl.py:16-27`) — includes d=0.0 and e=1..9
LEGACY_DISTANCES = (0.0, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 15.0, 25.0)
LEGACY_EFFORTS = tuple(range(1, 10))

# Decompression-stage table (restores old_test_jxl.py:476-502: the Rust
# harness dropped decompressed-size tracking; column parity with
# ImageDecompressionData.get_col_names(), old_test_jxl.py:133-158).
DECOMPRESSION_HEADER = [
    "Original Image Path",
    "Compressed Image Path",
    "Decompressed Image Path",
    "Compression Effort",
    "Compression Distance",
    "Image Dims",
    "Original Image Size",
    "Original Image Format",
    "Compressed Image Size",
    "Compressed Image Format",
    "Decompressed Image Size",
    "Decompressed Image Format",
    "Delta Original Image Size",
    "% of Original Image Size",
    "Delta Compressed Image Size",
    "% of Compressed Image Size",
]

# Per-grid-point timing rows (written to timings.csv, NOT the reference
# 17-col schema: that file stays byte-compatible).
TIMINGS_HEADER = [
    "Image Name",
    "Distance",
    "Effort",
    "Encode Time (s)",
    "Decode Time (s)",
    "Metrics Time (s)",
    "Encode MP/s",
    "Decode MP/s",
    # 1 when this (geometry, effort, strategy, grid-shape) signature was
    # already compiled this process, 0 when the row includes jit compile —
    # downstream averaging must filter Warm == 1 (the
    # first grid row otherwise silently mixes ~seconds of XLA compile into
    # the throughput columns).
    "Warm",
]


@dataclass
class SweepConfig:
    benchmark_dir: str = "./benchmarks"
    test_image_dir: str = "./test_images"
    distances: Sequence[float] = RUST_DISTANCES
    efforts: Sequence[int] = RUST_EFFORTS
    strategy: Strategy = Strategy.BASELINE
    keep_artifacts: bool = True  # write .jxt/.png outputs like the reference
    # legacy-pipeline stages (old_test_jxl.py:476-522): write decoded PNGs +
    # decompressed-size table / amplified |orig - decoded| diff images
    decompress: bool = False
    compare_images: bool = False
    # "data=N" or "data=N,space=M": encode batches of N images per mesh
    # dispatch (this framework's analog of the reference's N-worker pool,
    # config.rs:22) instead of one image row at a time. None = single-device.
    mesh: Optional[str] = None


def parse_mesh_spec(spec: str):
    """"data=4,space=2" -> a jax Mesh (space defaults to 1)."""
    from jxl_jax.distributed.mesh import make_mesh

    kv = dict(part.split("=") for part in spec.replace(" ", "").split(","))
    data = int(kv.get("data", 0)) or None
    space = int(kv.get("space", 1))
    return make_mesh((data or 1) * space if data else None, data=data, space=space)


def discover_test_sets(test_image_dir: str) -> list[str]:
    """Subdirectories of test_images/ (reference: `benchmark.rs:312-331`)."""
    if not os.path.isdir(test_image_dir):
        return []
    return sorted(
        d
        for d in os.listdir(test_image_dir)
        if os.path.isdir(os.path.join(test_image_dir, d))
    )


def next_run_number(benchmark_dir: str) -> int:
    """max(numeric dir) + 1 (reference: `benchmark.rs:280-302`)."""
    if not os.path.isdir(benchmark_dir):
        return 0
    nums = [int(d) for d in os.listdir(benchmark_dir) if d.isdigit()]
    return (max(nums) + 1) if nums else 0


class SweepRunner:
    """Runs the grid for one strategy ("commit" analog) over test sets."""

    def __init__(self, config: SweepConfig, run_dir: Optional[str] = None):
        self.config = config
        if run_dir is None:
            n = next_run_number(config.benchmark_dir)
            run_dir = os.path.join(config.benchmark_dir, str(n))
        self.run_dir = run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        # Compile-signature tracking for the timings.csv "Warm" column: a
        # row whose (geometry, effort, strategy, grid shape) was not yet
        # encoded this process includes XLA compile time in its wall times.
        self._warm_sigs: set = set()

    # --- resumability ------------------------------------------------------
    def _marker_path(self, test_set: str, strategy: Strategy) -> str:
        return os.path.join(self.run_dir, test_set, strategy.name, ".done.jsonl")

    def _load_done(self, test_set: str, strategy: Strategy) -> set:
        path = self._marker_path(test_set, strategy)
        done = set()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if line.strip():
                        rec = json.loads(line)
                        done.add((rec["image"], rec["d"], rec["e"]))
        return done

    def _mark_done(self, test_set: str, strategy: Strategy, image: str, d: float, e: int):
        path = self._marker_path(test_set, strategy)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps({"image": image, "d": d, "e": e}) + "\n")

    # --- paths (mirror the reference's 4 output dirs, benchmark.rs:107-137) -
    def out_dirs(self, test_set: str, strategy: Strategy) -> dict:
        base = os.path.join(self.run_dir, test_set, strategy.name)
        dirs = {
            "output": os.path.join(base, "output"),
            "results": os.path.join(base, "results"),
        }
        for p in dirs.values():
            os.makedirs(p, exist_ok=True)
        return dirs

    def results_csv(self, test_set: str, strategy: Strategy) -> str:
        return os.path.join(self.out_dirs(test_set, strategy)["results"], "results.csv")

    def comparisons_csv(self, test_set: str, strategy: Strategy) -> str:
        return os.path.join(
            self.out_dirs(test_set, strategy)["results"], "comparisons.csv"
        )

    def timings_csv(self, test_set: str, strategy: Strategy) -> str:
        """Per-grid-point wall times land on disk in a SEPARATE file so the
        17-column comparisons.csv stays byte-compatible with the reference
        schema (`csv_writer.rs:125-143`) — the reference never measures
        timing at all (SURVEY §5.1)."""
        return os.path.join(
            self.out_dirs(test_set, strategy)["results"], "timings.csv"
        )

    # --- main loop ---------------------------------------------------------
    def run_test_set(self, test_set: str, strategy: Optional[Strategy] = None) -> list:
        strategy = strategy or self.config.strategy
        ts_dir = os.path.join(self.config.test_image_dir, test_set)
        images = sorted(
            f
            for f in os.listdir(ts_dir)
            if os.path.splitext(f)[1].lower() in (".png", ".ppm", ".pnm", ".bmp", ".jpg", ".jpeg")
        )
        done = self._load_done(test_set, strategy)
        dirs = self.out_dirs(test_set, strategy)
        results_csv = self.results_csv(test_set, strategy)
        comparisons_csv = self.comparisons_csv(test_set, strategy)
        timings_csv = self.timings_csv(test_set, strategy)
        write_csv_header(results_csv, IMAGE_FILE_DATA_HEADER)
        write_csv_header(comparisons_csv, COMPARISON_RESULT_HEADER)
        write_csv_header(timings_csv, TIMINGS_HEADER)

        ctx = {
            "test_set": test_set,
            "strategy": strategy,
            "dirs": dirs,
            "comparisons_csv": comparisons_csv,
            "timings_csv": timings_csv,
        }

        all_rows = []
        if self.config.mesh:
            # Mesh mode: batches of mesh-"data"-size images encode as ONE
            # SPMD dispatch per effort (distributed.sharded.encode_grid_
            # sharded) — in place of the reference's worker pool (6 threads x
            # 6 containers, config.rs:22). Containers are byte-identical to
            # the single-device path, so decode/metrics/CSV are shared.
            mesh = parse_mesh_spec(self.config.mesh)
            metas, rgbs = {}, {}
            for image_name in images:
                img_path = os.path.join(ts_dir, image_name)
                metas[image_name] = read_image_metadata(
                    img_path, test_set=test_set, commit=strategy.name
                )
                append_rows(results_csv, [metas[image_name].csv_row()])
                rgbs[image_name] = read_image(img_path)

            from jxl_jax.distributed.sharded import encode_grid_sharded

            n_data = mesh.shape["data"]
            by_geom: dict = {}
            for name in images:
                by_geom.setdefault(rgbs[name].shape, []).append(name)
            for e in self.config.efforts:
                cfg = CodecConfig(effort=int(e), strategy=strategy)
                for geom_names in by_geom.values():
                    for i in range(0, len(geom_names), n_data):
                        batch_names = geom_names[i : i + n_data]
                        # mesh mode keeps full rows together: a point is
                        # re-encoded if any of its row is missing
                        batch_names = [
                            n
                            for n in batch_names
                            if any(
                                (n, d, e) not in done
                                for d in self.config.distances
                            )
                        ]
                        if not batch_names:
                            continue
                        lossy_ds = [d for d in self.config.distances if d > 0.0]
                        sig = (
                            "mesh",
                            rgbs[batch_names[0]].shape,
                            int(e),
                            strategy.name,
                            len(lossy_ds),
                            len(batch_names),
                        )
                        warm = 1 if sig in self._warm_sigs else 0
                        self._warm_sigs.add(sig)
                        t0 = time.perf_counter()
                        try:
                            grids = encode_grid_sharded(
                                [rgbs[n] for n in batch_names],
                                cfg,
                                lossy_ds,
                                mesh=mesh,
                                orig_names=batch_names,
                            )
                        except Exception as exc:  # skip-on-failure
                            print(
                                f"[sweep] mesh encode failed for batch "
                                f"{batch_names} e{e}: {exc!r}; skipping"
                            )
                            continue
                        n_pts = max(1, len(batch_names) * len(lossy_ds))
                        encode_s = (time.perf_counter() - t0) / n_pts
                        for name, datas in zip(batch_names, grids):
                            todo, blobs = [], []
                            for d, blob in zip(lossy_ds, datas):
                                if (name, d, e) not in done:
                                    todo.append(d)
                                    blobs.append(blob)
                            for d in self.config.distances:
                                if d <= 0.0 and (name, d, e) not in done:
                                    todo.insert(0, d)
                                    blobs.insert(
                                        0,
                                        encode_image(
                                            rgbs[name],
                                            CodecConfig(
                                                distance=0.0,
                                                effort=int(e),
                                                strategy=strategy,
                                            ),
                                            orig_name=name,
                                        ),
                                    )
                            all_rows.extend(
                                self._finish_row(
                                    ctx,
                                    name,
                                    metas[name],
                                    rgbs[name],
                                    e,
                                    todo,
                                    blobs,
                                    encode_s,
                                    warm,
                                )
                            )
            return all_rows

        for image_name in images:
            img_path = os.path.join(ts_dir, image_name)
            meta = read_image_metadata(img_path, test_set=test_set, commit=strategy.name)
            append_rows(results_csv, [meta.csv_row()])
            rgb = read_image(img_path)
            stem = os.path.splitext(image_name)[0]

            for e in self.config.efforts:
                todo = [
                    d for d in self.config.distances if (image_name, d, e) not in done
                ]
                if not todo:
                    continue
                # one dispatch per (image, effort): the whole distance row of
                # the grid is encoded as a vmapped batch (encode_image_grid);
                # d=0.0 (true lossless, legacy grid) runs its own modular
                # program outside the lossy vmap
                lossless_ds = [d for d in todo if d <= 0.0]
                lossy_ds = [d for d in todo if d > 0.0]
                sig = (rgb.shape, int(e), strategy.name, len(lossy_ds), bool(lossless_ds))
                warm = 1 if sig in self._warm_sigs else 0
                self._warm_sigs.add(sig)
                t0 = time.perf_counter()
                try:
                    cfg = CodecConfig(effort=int(e), strategy=strategy)
                    datas_by_d = {}
                    if lossy_ds:
                        for d, blob in zip(
                            lossy_ds,
                            encode_image_grid(rgb, cfg, lossy_ds, orig_name=image_name),
                        ):
                            datas_by_d[d] = blob
                    for d in lossless_ds:
                        datas_by_d[d] = encode_image(
                            rgb,
                            CodecConfig(distance=0.0, effort=int(e), strategy=strategy),
                            orig_name=image_name,
                        )
                    datas = [datas_by_d[d] for d in todo]
                except Exception as exc:  # skip-on-failure (benchmark.rs:661-677)
                    print(
                        f"[sweep] grid encode failed for {stem} e{e}: {exc!r}; skipping"
                    )
                    continue
                encode_s = (time.perf_counter() - t0) / max(1, len(todo))
                all_rows.extend(
                    self._finish_row(
                        ctx, image_name, meta, rgb, e, todo, datas, encode_s, warm
                    )
                )
        return all_rows

    def _finish_row(self, ctx, image_name, meta, rgb, e, todo, datas, encode_s, warm=1):
        """Decode + metric battery + CSV rows for one (image, effort) row of
        already-encoded containers. Shared by the single-device and mesh
        paths (containers are byte-identical between them)."""
        if not todo:
            return []
        test_set, strategy = ctx["test_set"], ctx["strategy"]
        dirs = ctx["dirs"]
        comparisons_csv, timings_csv = ctx["comparisons_csv"], ctx["timings_csv"]
        stem = os.path.splitext(image_name)[0]

        import jax
        import jax.numpy as jnp

        from jxl_jax.codec.container import read_container
        from jxl_jax.codec.decode import (
            decode_bytes_grid_stacked,
            decode_stream_device,
        )
        from jxl_jax.metrics.battery import metric_battery_grid_async

        rgb_dev = jnp.asarray(rgb)  # upload the original once
        legacy = self.config.decompress or self.config.compare_images
        # The whole distance row decodes as ONE dispatch to a STACKED
        # [N, H, W, 3] device array, and the metric battery consumes the
        # stack in ONE more dispatch + one [N, 6] fetch — per-point device
        # ops (slices, per-pair batteries) would each cost a dispatch and a
        # host round-trip. Decode and metric-battery wall
        # time are measured SEPARATELY (the reference measures neither).
        t1 = time.perf_counter()
        stacked = decode_bytes_grid_stacked(datas)
        if stacked is not None:
            jax.block_until_ready(stacked)
        else:  # mixed geometry / lossless points: per-stream decodes
            outs = [decode_stream_device(read_container(b)) for b in datas]
            jax.block_until_ready(outs)
        decode_s = (time.perf_counter() - t1) / max(1, len(todo))

        t2 = time.perf_counter()
        if stacked is not None:
            metrics = metric_battery_grid_async(rgb_dev, stacked)()
            host_px = np.asarray(jax.device_get(stacked)) if legacy else None
        else:
            pending = [metric_battery_async(rgb_dev, o) for o in outs]
            metrics = [f() for f in pending]
            host_px = (
                np.stack([np.asarray(jax.device_get(o)) for o in outs])
                if legacy
                else None
            )
        rows_meta = []
        for (d, data), m in zip(zip(todo, datas), metrics):
            comp_name = f"{stem}-{d}-{e}.jxt"
            if self.config.keep_artifacts:
                with open(os.path.join(dirs["output"], comp_name), "wb") as f:
                    f.write(data)
            rows_meta.append((d, data, comp_name, m))
        metrics_s = (time.perf_counter() - t2) / max(1, len(todo))

        if legacy:
            self._legacy_stages(ctx, image_name, meta, rgb, e, todo, datas, host_px)

        mp = rgb.shape[0] * rgb.shape[1] / 1e6
        append_rows(
            timings_csv,
            [
                [
                    image_name,
                    d,
                    e,
                    f"{encode_s:.6f}",
                    f"{decode_s:.6f}",
                    f"{metrics_s:.6f}",
                    f"{mp / encode_s:.3f}",
                    f"{mp / decode_s:.3f}",
                    warm,
                ]
                for d in todo
            ],
        )

        rows = []
        for d, data, comp_name, m in rows_meta:
            row = self._compare_to_orig(meta, comp_name, m, len(data), d, e)
            append_rows(comparisons_csv, [row.row()])
            self._mark_done(test_set, strategy, image_name, d, e)
            rows.append(row)
            print(
                f"[sweep] {test_set}/{comp_name}: "
                f"bpp={len(data) * 8 / (rgb.shape[0] * rgb.shape[1]):.3f} "
                f"psnr={row.psnr:.2f} enc={mp / encode_s:.2f}MP/s "
                f"dec={mp / decode_s:.2f}MP/s metrics={metrics_s * 1e3:.1f}ms"
            )
        return rows

    def _legacy_stages(self, ctx, image_name, meta, rgb, e, todo, datas, host_px):
        """Legacy-pipeline stages the Rust harness dropped (SURVEY §2.5):

        --decompress: write each decoded image as PNG into decompressed/
        and append a 16-col row (column parity with old_test_jxl.py's
        ImageDecompressionData) to decompressed.csv — decompressed size
        tables vs original AND vs compressed (old_test_jxl.py:476-502).
        --compare-images: write amplified |orig - decoded| diff images into
        diffs/ (the ImageMagick `compare` stage, old_test_jxl.py:505-522,
        without the external tool). host_px: [N, H, W, 3] u8 host pixels
        (fetched once for the whole row)."""
        from jxl_jax.core.io import write_image

        test_set, strategy = ctx["test_set"], ctx["strategy"]
        base = os.path.join(self.run_dir, test_set, strategy.name)
        stem = os.path.splitext(image_name)[0]
        orig_fmt = os.path.splitext(image_name)[1].lstrip(".").upper() or "PNG"
        h_px, w_px = rgb.shape[0], rgb.shape[1]

        dec_rows = []
        for i, (d, data) in enumerate(zip(todo, datas)):
            px = host_px[i]
            comp_path = os.path.join(base, "output", f"{stem}-{d}-{e}.jxt")
            if self.config.decompress:
                dec_dir = os.path.join(base, "decompressed")
                os.makedirs(dec_dir, exist_ok=True)
                dec_path = os.path.join(dec_dir, f"{stem}-{d}-{e}.png")
                write_image(dec_path, px)
                dec_size = os.path.getsize(dec_path)
                dec_rows.append(
                    [
                        os.path.join(self.config.test_image_dir, test_set, image_name),
                        comp_path,
                        dec_path,
                        e,
                        d,
                        f"{w_px}x{h_px}",
                        meta.file_size,
                        orig_fmt,
                        len(data),
                        "JXT",
                        dec_size,
                        "PNG",
                        dec_size - meta.file_size,
                        f"{dec_size / max(meta.file_size, 1) * 100:.4f}",
                        dec_size - len(data),
                        f"{dec_size / max(len(data), 1) * 100:.4f}",
                    ]
                )
            if self.config.compare_images:
                diff_dir = os.path.join(base, "diffs")
                os.makedirs(diff_dir, exist_ok=True)
                diff = np.abs(
                    rgb.astype(np.int16) - px.astype(np.int16)
                )
                amp = np.clip(diff * 8, 0, 255).astype(np.uint8)
                write_image(os.path.join(diff_dir, f"{stem}-{d}-{e}-diff.png"), amp)
        if dec_rows:
            dec_csv = os.path.join(base, "results", "decompressed.csv")
            write_csv_header(dec_csv, DECOMPRESSION_HEADER)
            append_rows(dec_csv, dec_rows)

    def _compare_to_orig(
        self, meta, comp_name, m, comp_size, d, e
    ) -> ComparisonResult:
        """ComparisonResult row from a fetched metric battery dict
        (reference: `benchmark.rs:895-975`). The battery itself runs
        device-resident in ONE fused program (metrics/battery.py) — decoded
        pixels never leave the device."""
        mse, psnr, ssim, ms_ssim = m["mse"], m["psnr"], m["ssim"], m["ms_ssim"]
        butteraugli, pnorm = m["butteraugli"], m["butteraugli_pnorm"]
        ssimulacra2 = m["ssimulacra2"]
        raw = meta.raw_size
        return ComparisonResult(
            orig_image_name=meta.image_name,
            comp_image_name=comp_name,
            distance=float(d),
            effort=int(e),
            orig_file_size=meta.file_size,
            comp_file_size=comp_size,
            orig_raw_size=raw,
            comp_raw_size=raw,
            comp_file_size_ratio=file_size_ratio(meta.file_size, comp_size),
            raw_file_size_ratio=file_size_ratio(raw, comp_size),
            mse=mse,
            psnr=psnr,
            ssim=ssim,
            ms_ssim=ms_ssim,
            butteraugli=butteraugli,
            butteraugli_pnorm=pnorm,
            ssimulacra2=ssimulacra2,
        )
