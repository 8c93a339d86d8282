"""Fresh-process CLI latency attribution.

Stamps wall-clock at every phase of a fresh-process decode or encode so
the one-shot CLI floor is attributable:

  python tools/profile_startup.py /tmp/s0.jxt        # decode profile
  python tools/profile_startup.py --encode img.png   # encode profile

Phases: interpreter+imports, first jax API touch, backend/device
acquisition, first tiny dispatch, codec program compile (cache hit or
miss), codec execute, host IO.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T0 = time.perf_counter()
MARKS = [("proc_start", 0.0)]


def mark(name):
    MARKS.append((name, time.perf_counter() - T0))


def main():
    encode_mode = "--encode" in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    path = args[0] if args else None

    import jax  # noqa: E402

    mark("import_jax")
    import jxl_jax  # noqa: E402  (configures cache dirs)

    mark("import_jxl_jax")
    devs = jax.devices()
    mark(f"jax_devices[{devs[0].platform}]")
    import jax.numpy as jnp

    jnp.add(jnp.ones(()), 1.0).block_until_ready()
    mark("first_tiny_dispatch")

    if encode_mode:
        from jxl_jax.codec.config import CodecConfig
        from jxl_jax.codec.encode import encode_image
        from jxl_jax.core.io import read_image

        rgb = read_image(path)
        mark("read_input")
        data = encode_image(rgb, CodecConfig(distance=1.0))
        mark("encode_1_compile+run")
        encode_image(rgb, CodecConfig(distance=1.0))
        mark("encode_2_steady")
        out = f"/tmp/profile_startup_{os.getpid()}.jxt"
        with open(out, "wb") as f:
            f.write(data)
        mark("write_output")
    else:
        from jxl_jax.codec.container import read_container
        from jxl_jax.codec.decode import decode_stream

        with open(path, "rb") as f:
            blob = f.read()
        stream = read_container(blob)
        mark("read+parse_container")
        px = decode_stream(stream)
        mark("decode_1_compile+run")
        decode_stream(stream)
        mark("decode_2_steady")
        from PIL import Image

        Image.fromarray(px).save(f"/tmp/profile_startup_{os.getpid()}.png")
        mark("write_output")

    deltas = {}
    for (n0, t0), (n1, t1) in zip(MARKS, MARKS[1:]):
        deltas[n1] = round(t1 - t0, 3)
    print(json.dumps({"total_s": round(MARKS[-1][1], 3), "phase_s": deltas}))


if __name__ == "__main__":
    main()
