"""Sharded batch encode — the multi-chip execution path.

The reference achieves corpus parallelism with 6 threads x 6 containers,
each container emitting a real `.jxl` artifact that is copied back to the
host (`benchmark.rs:81-104`, `:654-684`). The equivalent here is
stronger in kind: a batch of images is ONE jit-compiled SPMD program over a
("data", "space") mesh — images sharded over "data" (corpus DP), each
image's width sharded over "space" (the spatial/sequence-parallel axis) —
and the program is the FULL encoder (`codec.encode._encode_full_core`):
XYB, AC-strategy search, CfL, per-image histogram quantization, grouped
rANS, mantissa packing, single packed output buffer. XLA inserts the
collectives the shardings imply (histogram reductions and DC prefix sums
cross the "space" boundary). The host parses each image's packed buffer
into a real `.jxt` container — byte-identical to the single-device
`encode_image` output (asserted by tests/test_sharding.py and
`__graft_entry__.dryrun_multichip`).

`sharded_epf` additionally demonstrates EXPLICIT halo exchange (ppermute
ring collectives) for the decoder-side filter when one image's stripes live
on different devices.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jxl_jax.codec.config import CodecConfig
from jxl_jax.distributed.mesh import batch_sharding, make_mesh


def make_sharded_encode_step(
    mesh=None,
    *,
    height: int,
    width: int,
    effort: int = 7,
    hook_a: bool = False,
    hook_b: bool = False,
    lanes: int | None = None,
    max_lanes: int | None = None,
):
    """Jitted full-pipeline batch encoder over a ("data", "space") mesh.

    Returns (step, in_sharding, dist_sharding, meta) where
    `step(batch [B, H, W, 3] u8, distances [B] f32) -> (prefix [B, first],
    full [B, L])` — each row of `full` is the exact packed encoder buffer
    `codec.encode._encode_full_core` produces for that image on one device;
    `prefix` is the speculative first-fetch window (jit output, so the host
    can enqueue its D2H copy behind the compute). meta = dict with the
    lanes / layout / cap needed to parse the buffers.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jxl_jax.codec.encode import (
        _encode_full_core,
        _first_get_u32,
        pick_lanes,
    )
    from jxl_jax.codec.layout import padded_layout, token_layout
    from jxl_jax.entropy.tokens import byte_capacity

    if mesh is None:
        mesh = make_mesh()
    if lanes is None:
        lanes = pick_lanes(
            token_layout(height, width)["n_tokens"],
            max_lanes if max_lanes is not None else CodecConfig().lanes,
        )
    lay = padded_layout(height, width, lanes)
    cap = byte_capacity(lay["n_padded"])
    first = _first_get_u32(lanes, height * width)

    one = partial(
        _encode_full_core,
        height=height,
        width=width,
        effort=effort,
        hook_a=hook_a,
        hook_b=hook_b,
        lanes=lanes,
        cap_bytes=cap,
    )

    def batched(batch, distances):
        bufs = jax.vmap(one)(batch, distances)
        pref = jax.lax.slice(
            bufs, (0, 0), (bufs.shape[0], min(first, bufs.shape[1]))
        )
        return pref, bufs

    in_sharding = batch_sharding(mesh)
    dist_sharding = NamedSharding(mesh, P("data"))
    out_sharding = NamedSharding(mesh, P("data", None))
    step = jax.jit(
        batched,
        in_shardings=(in_sharding, dist_sharding),
        out_shardings=(out_sharding, out_sharding),
    )
    meta = {"lanes": lanes, "lay": lay, "cap_bytes": cap, "first": first}
    return step, in_sharding, dist_sharding, meta


def encode_batch_sharded(
    images,
    config: CodecConfig,
    distances=None,
    mesh=None,
    orig_names=None,
) -> list[bytes]:
    """Encode a batch of same-geometry images across the mesh; returns one
    `.jxt` container per image, byte-identical to `encode_image`'s output.

    images: list of [H, W, 3] u8 arrays (or one [B, H, W, 3] array).
    distances: per-image distance list (default: config.distance for all).
    The batch is padded up to a multiple of the mesh "data" size with
    repeats (dropped from the result); width must divide evenly over the
    "space" axis — callers pick the mesh to match their geometry.
    

    Note: the SPMD batch path always codes VarDCT — the round-5
    per-image VarDCT-vs-modular decision (codec/encode._pick_mode)
    is a host-side choice between two complete encodes and is not
    part of this single fused program; candidate content routed
    through here codes VarDCT (same contract as the striped path).
    """
    from jxl_jax.codec.encode import _assemble_container, _parse_packed

    batch = np.stack([np.asarray(im) for im in images])
    b, h, w = batch.shape[0], int(batch.shape[1]), int(batch.shape[2])
    if mesh is None:
        mesh = make_mesh()
    n_data = mesh.shape["data"]
    n_space = mesh.shape["space"]
    assert w % n_space == 0, (
        f"width {w} must divide over the space axis ({n_space})"
    )
    if distances is None:
        distances = [config.distance] * b
    distances = [max(float(d), 0.05) for d in distances]
    assert len(distances) == b
    if orig_names is None:
        orig_names = [""] * b

    pad = (-b) % n_data
    if pad:
        batch = np.concatenate([batch, batch[:1].repeat(pad, axis=0)])
        distances = distances + [distances[0]] * pad

    step, in_sharding, dist_sharding, meta = make_sharded_encode_step(
        mesh,
        height=h,
        width=w,
        effort=int(config.effort),
        hook_a=config.strategy.hook_a,
        hook_b=config.strategy.hook_b,
        max_lanes=config.lanes,  # same pick_lanes rule as encode_image
    )
    lanes, lay = meta["lanes"], meta["lay"]
    pref, bufs = step(
        jax.device_put(batch, in_sharding),
        jax.device_put(np.asarray(distances, np.float32), dist_sharding),
    )
    pref.copy_to_host_async()
    got_all = np.asarray(pref)

    out = []
    for i in range(b):
        cfg_d = replace(config, distance=distances[i])
        pieces = _parse_packed(got_all[i], bufs[i], lanes)
        out.append(
            _assemble_container(h, w, cfg_d, orig_names[i], lanes, lay, *pieces)
        )
    return out


def make_sharded_grid_step(
    mesh,
    *,
    height: int,
    width: int,
    effort: int = 7,
    hook_a: bool = False,
    hook_b: bool = False,
    max_lanes: int | None = None,
):
    """Like make_sharded_encode_step but over an (image batch x distance
    grid): `step(batch [B, H, W, 3], distances [D]) -> (prefix, full
    [B, D, L])`. Images shard over "data" / width over "space"; the
    distance axis is vmapped inside each image's program (the RD sweep's
    row). One dispatch covers B x D grid points."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jxl_jax.codec.encode import (
        _encode_full_core,
        _first_get_u32,
        pick_lanes,
    )
    from jxl_jax.codec.layout import padded_layout, token_layout
    from jxl_jax.entropy.tokens import byte_capacity

    if max_lanes is None:
        max_lanes = CodecConfig().lanes
    lanes = pick_lanes(token_layout(height, width)["n_tokens"], max_lanes)
    lay = padded_layout(height, width, lanes)
    cap = byte_capacity(lay["n_padded"])
    first = _first_get_u32(lanes, height * width)

    one = partial(
        _encode_full_core,
        height=height,
        width=width,
        effort=effort,
        hook_a=hook_a,
        hook_b=hook_b,
        lanes=lanes,
        cap_bytes=cap,
    )

    def batched(batch, distances):
        bufs = jax.vmap(lambda img: jax.vmap(lambda d: one(img, d))(distances))(
            batch
        )  # [B, D, L]
        pref = jax.lax.slice(
            bufs,
            (0, 0, 0),
            (bufs.shape[0], bufs.shape[1], min(first, bufs.shape[2])),
        )
        return pref, bufs

    in_sharding = batch_sharding(mesh)
    rep = NamedSharding(mesh, P())
    out_sharding = NamedSharding(mesh, P("data", None, None))
    step = jax.jit(
        batched,
        in_shardings=(in_sharding, rep),
        out_shardings=(out_sharding, out_sharding),
    )
    meta = {"lanes": lanes, "lay": lay, "cap_bytes": cap, "first": first}
    return step, in_sharding, rep, meta


def encode_grid_sharded(
    images,
    config: CodecConfig,
    distances,
    mesh=None,
    orig_names=None,
) -> list[list[bytes]]:
    """Encode a batch of same-geometry images at every distance of an RD
    sweep row in ONE mesh dispatch. Returns containers[img][dist] —
    byte-identical to per-image `encode_image_grid` output."""
    from jxl_jax.codec.encode import _assemble_container, _parse_packed

    batch = np.stack([np.asarray(im) for im in images])
    b, h, w = batch.shape[0], int(batch.shape[1]), int(batch.shape[2])
    if mesh is None:
        mesh = make_mesh()
    n_data = mesh.shape["data"]
    n_space = mesh.shape["space"]
    assert w % n_space == 0, (
        f"width {w} must divide over the space axis ({n_space})"
    )
    dists = [max(float(d), 0.05) for d in distances]
    if orig_names is None:
        orig_names = [""] * b

    pad = (-b) % n_data
    if pad:
        batch = np.concatenate([batch, batch[:1].repeat(pad, axis=0)])

    step, in_sharding, rep, meta = make_sharded_grid_step(
        mesh,
        height=h,
        width=w,
        effort=int(config.effort),
        hook_a=config.strategy.hook_a,
        hook_b=config.strategy.hook_b,
        max_lanes=config.lanes,
    )
    lanes, lay = meta["lanes"], meta["lay"]
    pref, bufs = step(
        jax.device_put(batch, in_sharding),
        jax.device_put(np.asarray(dists, np.float32), rep),
    )
    pref.copy_to_host_async()
    got_all = np.asarray(pref)

    out = []
    for i in range(b - pad if pad else b):
        row = []
        for j, d in enumerate(dists):
            cfg_d = replace(config, distance=d)
            pieces = _parse_packed(got_all[i, j], bufs[i, j], lanes)
            row.append(
                _assemble_container(
                    h, w, cfg_d, orig_names[i], lanes, lay, *pieces
                )
            )
        out.append(row)
    return out


def sharded_epf(planes, eff_mul, distance, mesh):
    """EPF over a width-sharded image with EXPLICIT halo exchange.

    The distributed analog of libjxl's cross-group filtering: each device
    holds a vertical stripe of the image ("space" axis); the 1-pixel column
    halos the cross-shaped kernel needs are exchanged with the ring
    neighbors via `ppermute` (neighbor collectives — the
    boundary-exchange pattern SURVEY §5.7 calls the ring-attention analog
    for images). Global image edges use edge replication, selected by
    axis_index so the ring wrap never leaks pixels across the image border.

    planes: [3, H, W] (W divisible by 8 * mesh "space" size),
    eff_mul: [nby, nbx]. Returns filtered [3, H, W] with the exact same
    values as the unsharded transforms.epf.epf_apply.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from jxl_jax.transforms.epf import epf_filter_ext, epf_sigma

    h, w = planes.shape[-2:]
    n_space = mesh.shape["space"]
    assert w % (8 * n_space) == 0, "width must split into whole block columns"
    sig = epf_sigma(eff_mul, distance, h, w)

    def body(pl_local, sig_local):
        idx = jax.lax.axis_index("space")
        left_edge = pl_local[:, :, :1]
        right_edge = pl_local[:, :, -1:]
        # ring exchange: receive the right neighbor's leftmost column and
        # the left neighbor's rightmost column
        fwd = [(i, (i + 1) % n_space) for i in range(n_space)]
        bwd = [(i, (i - 1) % n_space) for i in range(n_space)]
        from_left = jax.lax.ppermute(right_edge, "space", fwd)
        from_right = jax.lax.ppermute(left_edge, "space", bwd)
        # global borders replicate their own edge instead of ring-wrapping
        from_left = jnp.where(idx == 0, left_edge, from_left)
        from_right = jnp.where(idx == n_space - 1, right_edge, from_right)
        ext = jnp.concatenate([from_left, pl_local, from_right], axis=-1)
        ext = jnp.pad(ext, ((0, 0), (1, 1), (0, 0)), mode="edge")
        return epf_filter_ext(ext, sig_local)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, None, "space"), P(None, "space")),
        out_specs=P(None, None, "space"),
    )
    return fn(planes, sig)
