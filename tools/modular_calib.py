"""Modular-lossy calibration study.

Collects, for every corpus image and a distance grid, BOTH coding paths'
measured (bytes, PSNR):

  - VarDCT  (the round-4 codec path)
  - modular (codec/lossless.py with modular_steps(d) quantization)

and reports which path the shipped dominance rule
(codec/encode._pick_mode) selects, versus the RD-oracle pick (the path
whose interpolated curve needs fewer bits at the candidates' midpoint
PSNR). Use the JSON output to tune the step-law coefficients
(lossless._mod_coefs) and the rule constants (encode._mode_rule).

Run: python tools/modular_calib.py [out.json]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tools.rd_position_corpus import FAMILY

DISTANCES = (0.5, 0.7, 1.0, 1.4, 2.0, 3.0, 5.0)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-9))


def main():
    from jxl_jax.codec import encode
    from jxl_jax.codec.config import CodecConfig
    from jxl_jax.codec.decode import decode_bytes
    from jxl_jax.core.io import read_image

    out_path = sys.argv[1] if len(sys.argv) > 1 else "docs/modular_calib.json"
    os.environ["JXL_JAX_MODULAR"] = "0"  # VarDCT arm never runs the decision

    rows = []
    for name in sorted(FAMILY):
        rgb = read_image(f"test_images/synth/{name}.png")
        n_px = rgb.shape[0] * rgb.shape[1]
        cfg = CodecConfig(distance=1.0, effort=7)
        var_fin = encode.encode_image_grid_async(rgb, cfg, list(DISTANCES))
        mod_fin = encode._modular_grid_async(rgb, cfg, list(DISTANCES))
        var_datas, mod_datas = var_fin(), mod_fin()
        for i, d in enumerate(DISTANCES):
            rec_v = np.asarray(decode_bytes(var_datas[i]))
            rec_m = np.asarray(decode_bytes(mod_datas[i]))
            r = dict(
                name=name,
                family=FAMILY[name],
                d=d,
                var_bytes=len(var_datas[i]),
                var_psnr=psnr(rgb, rec_v),
                var_sse=float(
                    np.sum(
                        (rec_v.astype(np.float64) - rgb.astype(np.float64)) ** 2
                    )
                ),
                mod_bytes=len(mod_datas[i]),
                mod_psnr=psnr(rgb, rec_m),
                mod_sse=float(
                    np.sum(
                        (rec_m.astype(np.float64) - rgb.astype(np.float64)) ** 2
                    )
                ),
                n_px=n_px,
                candidate=bool(encode._modular_candidate(rgb)),
            )
            byte_win, sse_tol, sse_win, byte_tol = encode._mode_rule()
            rv, rm = r["var_bytes"], r["mod_bytes"]
            sv, sm = r["var_sse"], r["mod_sse"]
            r["pick_modular"] = bool(
                (rm <= rv and sm <= sv)
                or (rm <= byte_win * rv and sm <= sse_tol * sv)
                or (sm <= sse_win * sv and rm <= byte_tol * rv)
            )
            rows.append(r)
            print(json.dumps(r), flush=True)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
