"""Multi-device tests on the virtual 8-device CPU mesh (conftest)."""

import numpy as np
import pytest

import jax


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_mesh_shapes():
    from jxl_jax.distributed.mesh import make_mesh

    m = make_mesh(8)
    assert m.devices.shape == (8, 1)
    m2 = make_mesh(8, space=2)
    assert m2.devices.shape == (4, 2)
    assert m2.axis_names == ("data", "space")


@pytest.mark.slow  # the round driver runs dryrun_multichip(8) itself every round
def test_dryrun_multichip_8():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_encode_bit_exact_containers():
    """The DPxSP sharded batch encoder must emit real containers that are
    BYTE-IDENTICAL to the single-device `encode_image` output and decode
    back to the same pixels (the capability the reference's worker pool
    has: each worker produces a real artifact, `benchmark.rs:654-684`)."""
    from dataclasses import replace

    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.codec.encode import encode_image
    from jxl_jax.distributed.mesh import make_mesh
    from jxl_jax.distributed.sharded import encode_batch_sharded

    h = w = 64
    rng = np.random.default_rng(0)
    # smooth-ish content so every strategy/merge path gets exercised
    base = rng.normal(0.5, 0.1, (6, h, w, 1))
    batch = np.clip(
        base + rng.normal(0, 0.05, (6, h, w, 3)), 0, 1
    )
    batch = (batch * 255).astype(np.uint8)
    dists = [0.5, 1.0, 2.0, 1.0, 4.0, 1.5]
    cfg = CodecConfig(distance=1.0, effort=7)

    mesh = make_mesh(8, space=2)  # batch of 6 pads to 8 over data=4
    got = encode_batch_sharded(list(batch), cfg, distances=dists, mesh=mesh)
    assert len(got) == 6
    for i in range(6):
        want = encode_image(batch[i], replace(cfg, distance=dists[i]))
        assert got[i] == want, f"image {i} container differs"
        out = decode_bytes(got[i])
        assert out.shape == (h, w, 3)


def test_init_multihost_single_process_noop():
    """init_multihost must be safe to call unconditionally on one host."""
    from jxl_jax.distributed.mesh import init_multihost

    init_multihost()  # no coordinator: logs + continues standalone
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_sharded_epf_matches_unsharded():
    """Explicit ppermute halo exchange must reproduce the single-device EPF
    bit-for-bit (boundary handling included)."""
    import jax.numpy as jnp

    from jxl_jax.distributed.mesh import make_mesh
    from jxl_jax.distributed.sharded import sharded_epf
    from jxl_jax.transforms.epf import epf_apply

    rng = np.random.default_rng(7)
    h, w = 32, 8 * 8 * 4  # width splits over 4 space shards
    planes = jnp.asarray(rng.normal(0.4, 0.1, (3, h, w)).astype(np.float32))
    eff = jnp.asarray(rng.uniform(0.6, 2.0, (h // 8, w // 8)).astype(np.float32))

    want = np.asarray(epf_apply(planes, eff, 2.0))
    mesh = make_mesh(8, space=4)
    got = np.asarray(sharded_epf(planes, eff, 2.0, mesh))
    np.testing.assert_allclose(got, want, atol=1e-6)
