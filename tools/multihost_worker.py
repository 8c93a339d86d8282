"""One process of a REAL multi-process `jax.distributed` encode
(SURVEY §5.8).

Run two of these (tests/test_multihost.py does) with the same coordinator
address. Each process:

1. forces the CPU backend with 2 local virtual devices (two processes
   must not share one GPU: each would reserve most of its memory),
2. joins the process group via `distributed.mesh.init_multihost` — the real
   `jax.distributed.initialize` path, not the single-process no-op,
3. builds the GLOBAL ("data", "space") mesh spanning both processes'
   devices, assembles a globally-sharded batch from its process-LOCAL
   images (`local_batch_to_global`), and runs the full sharded encode step
   (one SPMD program: XYB -> ACS search -> RDO quant -> grouped rANS ->
   packed buffers) over the global mesh — cross-process collectives ride
   the distributed backend exactly as they would between hosts,
4. parses the ADDRESSABLE output shards back into `.jxt` containers and
   asserts each is BYTE-IDENTICAL to the single-device `encode_image`
   output for that image, then decodes it.

Usage: python tools/multihost_worker.py <coordinator> <num_procs> <pid>
Prints "MULTIHOST_OK pid=<pid> imgs=<n>" on success.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOCAL_DEVICES = 2
H, W = 64, 64


def main():
    coordinator, num_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_NUM_CPU_DEVICES"] = str(LOCAL_DEVICES)
    os.environ["JXL_JAX_NO_CACHE"] = "1"
    import jax

    from jxl_jax.distributed.mesh import (
        init_multihost,
        local_batch_to_global,
        make_mesh,
    )

    init_multihost(
        coordinator_address=coordinator, num_processes=num_procs, process_id=pid
    )
    assert jax.process_count() == num_procs, jax.process_count()
    n_global = num_procs * LOCAL_DEVICES
    assert len(jax.devices()) == n_global, len(jax.devices())

    import numpy as np

    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.codec.encode import _assemble_container, _parse_packed, encode_image
    from jxl_jax.distributed.sharded import make_sharded_encode_step

    def synth(seed):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        lum = np.clip(
            0.5 + 0.3 * np.sin(xx / 19.0) * np.cos(yy / 13.0)
            + rng.normal(0, 0.03, (H, W)),
            0,
            1,
        )
        rgb = np.stack([lum, lum * 0.9, lum * 0.8], axis=-1)
        return (rgb * 255).astype(np.uint8)

    # all processes know all seeds; each contributes only ITS local images
    all_imgs = [synth(100 + i) for i in range(n_global)]
    local = np.stack(all_imgs[pid * LOCAL_DEVICES : (pid + 1) * LOCAL_DEVICES])
    dists = np.asarray([1.0 + 0.5 * (i % 2) for i in range(n_global)], np.float32)

    mesh = make_mesh(n_global)  # data axis spans BOTH processes
    step, _in_sh, dist_sh, meta = make_sharded_encode_step(
        mesh, height=H, width=W, effort=7
    )
    g_batch = local_batch_to_global(local, mesh)
    g_dists = jax.make_array_from_process_local_data(
        dist_sh, dists[pid * LOCAL_DEVICES : (pid + 1) * LOCAL_DEVICES]
    )
    _pref, bufs = step(g_batch, g_dists)

    lanes, lay = meta["lanes"], meta["lay"]
    cfg = CodecConfig(distance=1.0, effort=7)
    n_ok = 0
    for shard in bufs.addressable_shards:
        i = shard.index[0].start  # global image index of this row
        row = np.asarray(shard.data)[0]
        pieces = _parse_packed(row, row, lanes)
        from dataclasses import replace

        cfg_i = replace(cfg, distance=float(dists[i]))
        blob = _assemble_container(H, W, cfg_i, "", lanes, lay, *pieces)
        ref = encode_image(all_imgs[i], cfg_i)
        assert blob == ref, f"pid={pid} img={i}: container != single-device"
        out = decode_bytes(blob)
        mse = ((out.astype(np.float64) - all_imgs[i].astype(np.float64)) ** 2).mean()
        assert 10 * np.log10(255.0**2 / mse) > 25.0
        n_ok += 1

    assert n_ok == LOCAL_DEVICES, n_ok
    print(f"MULTIHOST_OK pid={pid} imgs={n_ok}", flush=True)


if __name__ == "__main__":
    main()
