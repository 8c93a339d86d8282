"""Test config: run everything on a virtual 8-device CPU mesh.

Tests run on the CPU: sharding tests use XLA's host-platform device-count
simulation (the "fake backend" the reference never had — SURVEY §4
implications), Pallas kernels run in interpret mode, and tests marked
`gpu` skip (chip_smoke.py runs them on the card)."""

import os

# chip_smoke.py runs the `gpu` tests inside its own process, whose JAX
# already holds the card: leave the platform alone there.
if not os.environ.get("CHIP_SMOKE_IN_PROCESS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    # Persistent compile cache: JAX_COMPILATION_CACHE_DIR where it is set,
    # otherwise a fixed directory OUTSIDE the checkout, so CPU-test
    # artifacts never land in the tree. The suite is XLA-compile-bound, so
    # a warm cache cuts a full invocation severalfold; xdist workers share
    # it safely (file-per-program). JXL_JAX_NO_CACHE=1 opts out.
    if not os.environ.get("JXL_JAX_NO_CACHE"):
        os.environ.setdefault(
            "JAX_COMPILATION_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "jxl_jax", "cpu-tests"),
        )

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_test_image(h=128, w=160, seed=7):
    """Synthetic photographic-like image: gradients + edges + texture."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.3 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    edges = ((xx // 40 + yy // 32) % 2) * 0.25
    texture = r.normal(0, 0.02, (h, w)).astype(np.float32)
    lum = np.clip(base + edges + texture, 0, 1)
    rgb = np.stack(
        [
            lum * (0.8 + 0.2 * np.sin(yy / 50.0)),
            lum,
            lum * (0.7 + 0.3 * np.cos(xx / 60.0)),
        ],
        axis=-1,
    )
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="session")
def test_image():
    return make_test_image()
