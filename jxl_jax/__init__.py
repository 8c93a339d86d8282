"""jxl_jax — a JPEG XL-style lossy image codec + benchmarking framework in JAX.

Re-implements, as one JAX program per stage (XLA, plus a Pallas kernel for
the rANS decode scan on the GPU), the capabilities of the reference
`pscoro/JPEG-XL-Lossy-Image-Compression-Thesis`:

- a lossy VarDCT encode/decode engine (reference: external libjxl C++,
  invoked via Docker at `benchmark-jpegxl/src/docker_manager.rs:100`),
- the thesis's homogeneity AC-strategy proposals (reference:
  `proposals/*.diff` against `lib/jxl/enc_ac_strategy.cc`) as config flags,
- the quality-metrics suite (reference: `benchmark-jpegxl/src/metrics.rs`),
- the sweep + A/B comparison harness (reference:
  `benchmark-jpegxl/src/benchmark.rs`).

Unlike the reference, codec variants are configuration of one JAX engine, so
there is no checkout/patch/rebuild cycle; parallelism is `jax.sharding` over
device meshes instead of Docker-container worker pools.
"""

__version__ = "0.1.0"

import os as _os


def _refuse_foreign_knobs() -> None:
    """Every environment knob of this package is named JXL_JAX_*. Any other
    JXL_* variable (a misspelt knob, or a knob under the package's earlier
    name) would be ignored without a word and change what a run does, so it
    is an error."""
    bad = sorted(
        k for k in _os.environ if k.startswith("JXL_") and not k.startswith("JXL_JAX_")
    )
    if bad:
        raise RuntimeError(
            f"unknown environment variable(s) {', '.join(bad)}: the knobs of "
            "jxl_jax are named JXL_JAX_* (see README.md); rename or unset them"
        )


_refuse_foreign_knobs()

from jxl_jax.utils.jax_setup import configure_jax as _configure_jax

_configure_jax()

from jxl_jax.codec.config import CodecConfig, Strategy  # noqa: F401
