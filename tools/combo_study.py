"""Pick the v8 context configuration: measures ideal AC bits under
combinations of position granularity x nnz-bucket count, with signaling.

  b6   : channel x 6 bands                      (current)
  p63  : channel x 63 positions
  p63q2: channel x 63 positions x {empty, busy} block
  p63q4: channel x 63 positions x 4 nnz buckets (edges 1, 3, 8)
  b6q4 : channel x 6 bands x 4 buckets

Net numbers subtract the bucket-map signaling (causal residual entropy).
Run: python tools/combo_study.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def entropy_bits(counts):
    c = counts[counts > 0].astype(np.float64)
    n = c.sum()
    return float(n * np.log2(n) - (c * np.log2(c)).sum()) if n else 0.0


def study(name, rgb, distance, effort=7):
    import jax.numpy as jnp

    from jxl_jax.codec.analysis import encode_tokens_for_analysis as tokens_from_rgb
    from jxl_jax.codec.layout import ac_band_table, token_layout
    from jxl_jax.entropy.tokens import detokenize, zigzag_unmap

    h, w = rgb.shape[:2]
    lay = token_layout(h, w)
    token, _nb, mant, _c, _p = tokens_from_rgb(
        jnp.asarray(rgb), jnp.float32(distance), height=h, width=w, effort=effort
    )
    token = np.asarray(token)
    values = np.asarray(detokenize(jnp.asarray(token), jnp.asarray(mant)))
    nb = lay["nb"]
    ac_start = lay["n_acs"] + lay["n_qf"] + lay["n_cfl"] + lay["n_dc"]
    ac_tok = token[ac_start:].reshape(3, 63, nb)
    ac_val = np.asarray(zigzag_unmap(jnp.asarray(values[ac_start:]))).reshape(3, 63, nb)
    band = np.asarray(ac_band_table())
    nnz = (ac_val != 0).sum(axis=1)  # [3, nb]
    A = 64
    nby, nbx = lay["nby"], lay["nbx"]

    def buckets(edges):
        q = np.zeros_like(nnz)
        for e in edges:
            q += (nnz >= e).astype(nnz.dtype)
        return q

    def sig_bits(q):
        s = 0.0
        for c in range(3):
            v = q[c].reshape(nby, nbx).astype(np.int64)
            left = np.pad(v, ((0, 0), (1, 0)))[:, :-1]
            up = np.pad(v, ((1, 0), (0, 0)))[:-1, :]
            pred = left.copy()
            pred[:, 0] = up[:, 0]
            res = v - pred
            zz = np.where(res >= 0, 2 * res, -2 * res - 1)
            s += entropy_bits(np.bincount(zz.reshape(-1)))
        return s

    def cond_bits(pos_map, q, Q):
        bits = 0.0
        for c in range(3):
            for b in np.unique(pos_map):
                toks = ac_tok[c][pos_map == b]
                if Q == 1:
                    bits += entropy_bits(np.bincount(toks.reshape(-1), minlength=A))
                else:
                    for qq in range(Q):
                        sel = toks[:, q[c] == qq].reshape(-1)
                        bits += entropy_bits(np.bincount(sel, minlength=A))
        return bits

    pos = np.arange(63)
    q2 = buckets([1])
    q4 = buckets([1, 3, 8])
    base = cond_bits(band, None, 1)
    res = {
        "image": name,
        "d": distance,
        "ac_bits_b6": round(base),
    }
    for label, (pm, q, Q, sig) in {
        "p63": (pos, None, 1, 0.0),
        "p63q2": (pos, q2, 2, sig_bits(q2)),
        "p63q4": (pos, q4, 4, sig_bits(q4)),
        "b6q4": (band, q4, 4, sig_bits(q4)),
    }.items():
        bits = cond_bits(pm, q, Q) + sig
        res[label + "_net_pct"] = round(100 * (base - bits) / max(base, 1), 2)
    print(json.dumps(res))


def main():
    from bench import synth_kodak
    from jxl_jax.core.io import read_image

    images = {"bench": synth_kodak()}
    for f in ("synth00.png", "synth02.png", "synth04.png", "synth06.png"):
        p = os.path.join("test_images/synth", f)
        if os.path.exists(p):
            images[f] = read_image(p)
    for name, rgb in images.items():
        for d in (0.5, 1.0, 3.0):
            study(name, rgb, d)


if __name__ == "__main__":
    main()
