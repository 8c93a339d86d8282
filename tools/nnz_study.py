"""Estimate the rate win of nnz-bucket-conditioned AC contexts
BEFORE building it: tokenizes images with the current encoder,
reconstructs per-(channel, block) nonzero counts, and compares

  (a) current position-only contexts: H(token | channel, band)
  (b) bucket-conditioned:            H(token | channel, band, nnz bucket)

plus the cost of signaling the bucket map (raw entropy and causal-residual
entropy) for several candidate bucket edge sets. All entropies are computed
from exact token histograms (ideal-code bits), so the numbers bound what
the rANS layer can realize (quantization to 12-bit tables costs ~0.1%).

Run: python tools/nnz_study.py  (GPU or CPU; stats are identical)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def entropy_bits(counts: np.ndarray) -> float:
    """Ideal-code bits to send symbols with these counts (own table)."""
    c = counts[counts > 0].astype(np.float64)
    n = c.sum()
    if n == 0:
        return 0.0
    return float(n * np.log2(n) - (c * np.log2(c)).sum())


def study_image(name, rgb, distance, effort=7):
    import jax.numpy as jnp

    from jxl_jax.codec.analysis import encode_tokens_for_analysis as tokens_from_rgb
    from jxl_jax.codec.layout import N_BANDS, ac_band_table, token_layout
    from jxl_jax.entropy.tokens import detokenize, token_nbits, zigzag_unmap

    h, w = rgb.shape[:2]
    lay = token_layout(h, w)
    token, nbits, mant, _counts, _params = tokens_from_rgb(
        jnp.asarray(rgb), jnp.float32(distance), height=h, width=w, effort=effort
    )
    token = np.asarray(token)
    mant = np.asarray(mant)
    values = np.asarray(detokenize(jnp.asarray(token), jnp.asarray(mant)))
    nb = lay["nb"]
    ac_start = lay["n_acs"] + lay["n_qf"] + lay["n_cfl"] + lay["n_dc"]
    ac_tok = token[ac_start:].reshape(3, 63, nb)  # z-major
    ac_val = zigzag_unmap(jnp.asarray(values[ac_start:])).reshape(3, 63, nb)
    ac_val = np.asarray(ac_val)
    band = np.asarray(ac_band_table())  # [63]

    nnz = (ac_val != 0).sum(axis=1)  # [3, nb]
    # mantissa bits ride outside the entropy coder; identical in both
    # schemes, so exclude them from the comparison
    A = int(token.max()) + 1

    # (a) current: context = (channel, band)
    bits_now = 0.0
    for c in range(3):
        for b in range(N_BANDS):
            sel = ac_tok[c][band == b].reshape(-1)
            bits_now += entropy_bits(np.bincount(sel, minlength=A))

    out = {
        "image": name,
        "d": distance,
        "ac_bits_now": bits_now,
        "nnz_hist": np.bincount(nnz.reshape(-1), minlength=64)[:24].tolist(),
        "frac_empty_cb": float((nnz == 0).mean()),
        "buckets": {},
    }

    edge_sets = {
        "4@0,1,3,8": [1, 3, 8],
        "6@0,1,2,4,8,16": [1, 2, 4, 8, 16],
        "8@0,1,2,3,5,8,13,24": [1, 2, 3, 5, 8, 13, 24],
    }
    for label, edges in edge_sets.items():
        q = np.zeros_like(nnz)
        for e in edges:
            q += (nnz >= e).astype(nnz.dtype)
        Q = len(edges) + 1
        # (b) conditioned: context = (channel, band, bucket)
        bits_cond = 0.0
        for c in range(3):
            for b in range(N_BANDS):
                toks_b = ac_tok[c][band == b]  # [bs, nb]
                for qq in range(Q):
                    sel = toks_b[:, q[c] == qq].reshape(-1)
                    bits_cond += entropy_bits(np.bincount(sel, minlength=A))
        # bucket signaling cost: raw per-channel entropy, and causal
        # L-column residual entropy (the map_field machinery)
        sig_raw = sum(
            entropy_bits(np.bincount(q[c], minlength=Q)) for c in range(3)
        )
        nby, nbx = lay["nby"], lay["nbx"]
        sig_res = 0.0
        for c in range(3):
            v = q[c].reshape(nby, nbx).astype(np.int64)
            left = np.pad(v, ((0, 0), (1, 0)))[:, :-1]
            up = np.pad(v, ((1, 0), (0, 0)))[:-1, :]
            pred = left.copy()
            pred[:, 0] = up[:, 0]
            res = v - pred
            zz = np.where(res >= 0, 2 * res, -2 * res - 1)
            sig_res += entropy_bits(np.bincount(zz.reshape(-1)))
        out["buckets"][label] = {
            "ac_bits_cond": bits_cond,
            "sig_bits_raw": sig_raw,
            "sig_bits_res": sig_res,
            "net_saving_bits": bits_now - bits_cond - min(sig_raw, sig_res),
            "net_saving_pct_of_ac": 100.0
            * (bits_now - bits_cond - min(sig_raw, sig_res))
            / max(bits_now, 1.0),
        }
    return out


def main():
    from bench import synth_kodak
    from jxl_jax.core.io import read_image

    images = {"bench": synth_kodak()}
    corpus_dir = "test_images/synth"
    if os.path.isdir(corpus_dir):
        for f in sorted(os.listdir(corpus_dir))[:4]:
            if f.endswith(".png"):
                images[f] = read_image(os.path.join(corpus_dir, f))

    for name, rgb in images.items():
        for d in (0.5, 1.0, 3.0):
            r = study_image(name, rgb, d)
            # compact print: per-edge-set net savings
            summ = {
                k: round(v["net_saving_pct_of_ac"], 2)
                for k, v in r["buckets"].items()
            }
            print(
                json.dumps(
                    {
                        "image": name,
                        "d": d,
                        "ac_bits_now": round(r["ac_bits_now"]),
                        "frac_empty_cb": round(r["frac_empty_cb"], 3),
                        "net_saving_pct_of_ac": summ,
                        "sig_res_bits": {
                            k: round(v["sig_bits_res"])
                            for k, v in r["buckets"].items()
                        },
                    }
                )
            )


if __name__ == "__main__":
    main()
