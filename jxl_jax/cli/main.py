"""CLI — encode / decode / bench / compare subcommands.

Covers both reference entry points with one tool:
- `bench` reproduces `benchmark-jpegxl`'s flags (`main.rs:16-29`):
  `--clean`, `--temp`, strategy selection replaces `--libjxl_commit`,
  `--compare-to` replaces `--compare_to_local`/`--compare_to_commit`
  (variants are flags of one engine, no containers to rebuild).
- `encode`/`decode` replace the `cjxl`/`djxl` shell-outs of the legacy
  pipeline (`old_test_jxl.py:460-491`).

Usage:
  python -m jxl_jax encode in.png out.jxt --distance 1.0 --effort 7
  python -m jxl_jax decode out.jxt back.png
  python -m jxl_jax bench --test-image-dir ./test_images --grid rust
  python -m jxl_jax bench --strategy HOMOGENEITY_PARTITIONING --compare-to BASELINE
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

_PROC_T0 = time.perf_counter()


def _suggest_serve():
    """After a slow one-shot invocation, point at the persistent server
    (backend start-up and compilation dominate a fresh process)."""
    if time.perf_counter() - _PROC_T0 > 30 and not os.environ.get(
        "JXL_JAX_NO_SERVER"
    ):
        print(
            "[hint] most of that was per-process backend startup; run "
            "`python -m jxl_jax serve &` once and repeat invocations "
            "complete in seconds",
            file=sys.stderr,
        )


def _add_codec_args(p):
    p.add_argument("--distance", type=float, default=1.0, help="quality (cjxl --distance analog)")
    p.add_argument("--effort", type=int, default=7, help="encode effort 1-9 (cjxl --effort analog)")
    p.add_argument(
        "--strategy",
        default="BASELINE",
        help="codec variant: BASELINE | HOMOGENEITY_PARTITIONING | HOMOGENEITY_FACTORED_ENTROPY | COMBINED",
    )
    p.add_argument(
        "--lanes",
        type=int,
        default=256,
        help="interleaved rANS streams (128-multiple). The default 256 "
        "AUTO-GROWS to 512/1024 for >= 2/4 MP images (2-4x fewer serial "
        "decode steps, +<=0.5%% container); any other value pins the count",
    )


def _forward(req: dict):
    """try_forward, with a refused local run (ServerBusy) reported on
    stderr: returns (reply or None, exit code or None)."""
    from jxl_jax.cli.server import ServerBusy, try_forward

    try:
        return try_forward(req), None
    except ServerBusy as e:
        print(f"error: {e}", file=sys.stderr)
        return None, 2


def cmd_encode(args) -> int:
    # auto-forward to a running persistent server (python -m jxl_jax serve):
    # a fresh process pays the full backend start-up per invocation
    rep, rc = _forward(
        dict(
            cmd="encode",
            input=os.path.abspath(args.input),
            output=os.path.abspath(args.output),
            distance=args.distance,
            effort=args.effort,
            strategy=args.strategy,
            lanes=getattr(args, "lanes", 256),
            stripes=getattr(args, "stripes", 0),
        )
    )
    if rc is not None:
        return rc
    if rep is not None:
        print(rep.get("msg") or rep.get("error"))
        return 0 if rep.get("ok") else 1

    from jxl_jax.codec.config import CodecConfig, Strategy
    from jxl_jax.codec.encode import encode_file
    from jxl_jax.core.io import read_image

    cfg = CodecConfig(
        distance=args.distance,
        effort=args.effort,
        strategy=Strategy[args.strategy],
        lanes=getattr(args, "lanes", 256),
    )
    rgb = read_image(args.input)
    t0 = time.perf_counter()
    if getattr(args, "stripes", 0):
        from jxl_jax.codec.tiled import encode_image_striped

        data = encode_image_striped(
            rgb, cfg, n_stripes=args.stripes, orig_name=os.path.basename(args.input)
        )
        with open(args.output, "wb") as f:
            f.write(data)
        size = len(data)
    else:
        size = encode_file(args.input, args.output, cfg)
    dt = time.perf_counter() - t0
    mp = rgb.shape[0] * rgb.shape[1] / 1e6
    bpp = size * 8 / (rgb.shape[0] * rgb.shape[1])
    print(f"{args.output}: {size} bytes, {bpp:.3f} bpp, {mp / dt:.2f} MP/s")
    _suggest_serve()
    return 0


def cmd_decode(args) -> int:
    rep, rc = _forward(
        dict(
            cmd="decode",
            input=os.path.abspath(args.input),
            output=os.path.abspath(args.output),
        )
    )
    if rc is not None:
        return rc
    if rep is not None:
        print(rep.get("msg") or rep.get("error"))
        return 0 if rep.get("ok") else 1

    from jxl_jax.codec.decode import decode_file
    from jxl_jax.core.io import write_image

    t0 = time.perf_counter()
    rgb = decode_file(args.input)
    dt = time.perf_counter() - t0
    write_image(args.output, rgb)
    mp = rgb.shape[0] * rgb.shape[1] / 1e6
    print(f"{args.output}: {rgb.shape[1]}x{rgb.shape[0]}, {mp / dt:.2f} MP/s")
    _suggest_serve()
    return 0


def cmd_serve(args) -> int:
    from jxl_jax.cli.server import DEFAULT_SOCKET, serve

    return serve(args.socket or DEFAULT_SOCKET)


def cmd_bench(args) -> int:
    if getattr(args, "profile", None):
        # jax.profiler trace of the whole sweep (view with xprof/tensorboard)
        import jax

        jax.profiler.start_trace(args.profile)
    try:
        return _cmd_bench_inner(args)
    finally:
        if getattr(args, "profile", None):
            import jax

            jax.profiler.stop_trace()
            print(f"[bench] profiler trace written to {args.profile}")


def _cmd_bench_inner(args) -> int:
    from jxl_jax.bench.compare import compare_results
    from jxl_jax.bench.sweep import (
        LEGACY_DISTANCES,
        LEGACY_EFFORTS,
        RUST_DISTANCES,
        RUST_EFFORTS,
        SweepConfig,
        SweepRunner,
        discover_test_sets,
    )
    from jxl_jax.codec.config import Strategy

    bench_dir = args.benchmark_dir
    if args.temp:  # --temp: suffix the dir (main.rs:50-58)
        i = 0
        while os.path.exists(f"{bench_dir}-{i}"):
            i += 1
        bench_dir = f"{bench_dir}-{i}"
    if args.clean and os.path.exists(args.benchmark_dir):  # --clean (main.rs:61-66)
        shutil.rmtree(args.benchmark_dir)

    if args.graph:
        try:
            from jxl_jax.bench.plots import boxplot_size_percent, rd_curves
        except ImportError as e:
            print(f"--graph needs matplotlib: {e}", file=sys.stderr)
            return 1

    grid = {
        "rust": (RUST_DISTANCES, RUST_EFFORTS),
        "legacy": (LEGACY_DISTANCES, LEGACY_EFFORTS),
    }[args.grid]
    distances = tuple(args.distances) if args.distances else grid[0]
    efforts = tuple(args.efforts) if args.efforts else grid[1]

    cfg = SweepConfig(
        benchmark_dir=bench_dir,
        test_image_dir=args.test_image_dir,
        distances=distances,
        efforts=efforts,
        strategy=Strategy[args.strategy],
        mesh=args.mesh,
        decompress=args.decompress,
        compare_images=args.compare_images,
    )
    runner = SweepRunner(cfg)
    test_sets = discover_test_sets(args.test_image_dir)
    if not test_sets:
        print(f"no test sets under {args.test_image_dir}", file=sys.stderr)
        return 1

    strategies = [Strategy[args.strategy]]
    if args.compare_to:
        strategies.append(Strategy[args.compare_to])

    for ts in test_sets:
        csvs = []
        for strat in strategies:
            runner.run_test_set(ts, strat)
            csvs.append(runner.comparisons_csv(ts, strat))
            if args.graph:
                base = runner.out_dirs(ts, strat)["results"]
                boxplot_size_percent(csvs[-1], os.path.join(base, "boxplot.png"))
                rd_curves(csvs[-1], os.path.join(base, "rd_curves.png"))
        if len(csvs) == 2:  # exactly-2 rule (benchmark.rs:554-563)
            out = os.path.join(runner.run_dir, ts)
            diffs, summary = compare_results(csvs[0], csvs[1], out)
            print(f"[bench] wrote {diffs} and {summary}")
    print(f"[bench] run dir: {runner.run_dir}")
    return 0


def cmd_compare(args) -> int:
    from jxl_jax.bench.compare import compare_results

    diffs, summary = compare_results(args.csv1, args.csv2, args.out_dir)
    print(f"wrote {diffs}\nwrote {summary}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="jxl_jax")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="encode an image to .jxt")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument(
        "--stripes",
        type=int,
        default=0,
        help="encode as N independent full-height stripes (JXTS gigapixel "
        "container; 0 = single-section)",
    )
    _add_codec_args(pe)
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="decode a .jxt to an image")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.set_defaults(fn=cmd_decode)

    ps = sub.add_parser(
        "serve",
        help="persistent codec server: later encode/decode invocations "
        "auto-forward over a unix socket instead of paying backend "
        "startup per process (JXL_JAX_NO_SERVER=1 opts a client out)",
    )
    ps.add_argument("--socket", default=None, help="unix socket path")
    ps.set_defaults(fn=cmd_serve)

    pb = sub.add_parser("bench", help="run the RD sweep benchmark")
    pb.add_argument("--benchmark-dir", default="./benchmarks")
    pb.add_argument("--test-image-dir", default="./test_images")
    pb.add_argument("--clean", action="store_true", help="delete benchmark dir first")
    pb.add_argument("--temp", action="store_true", help="use a fresh suffixed dir")
    pb.add_argument("--grid", choices=("rust", "legacy"), default="rust")
    pb.add_argument("--distances", type=float, nargs="*", default=None)
    pb.add_argument("--efforts", type=int, nargs="*", default=None)
    pb.add_argument("--compare-to", default=None, help="second strategy for A/B diff")
    pb.add_argument("--graph", action="store_true", help="write boxplots + RD curves")
    pb.add_argument(
        "--decompress",
        action="store_true",
        help="write decoded PNGs + decompressed-size table (legacy stage, old_test_jxl.py:476-502)",
    )
    pb.add_argument(
        "--compare-images",
        action="store_true",
        help="write amplified |orig-decoded| diff images (legacy stage, old_test_jxl.py:505-522)",
    )
    pb.add_argument(
        "--mesh",
        default=None,
        metavar="SPEC",
        help=(
            "encode image batches across a device mesh, e.g. 'data=4' or "
            "'data=4,space=2' (images over data, width over space); takes "
            "the place of the reference's 6-worker pool"
        ),
    )
    pb.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler trace of the sweep into DIR",
    )
    _add_codec_args(pb)
    pb.set_defaults(fn=cmd_bench)

    pc = sub.add_parser("compare", help="diff two comparisons.csv files")
    pc.add_argument("csv1")
    pc.add_argument("csv2")
    pc.add_argument("out_dir")
    pc.set_defaults(fn=cmd_compare)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
