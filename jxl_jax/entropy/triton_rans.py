"""GPU kernel: grouped rANS decode scan (the codec's only serial op).

Pallas through Triton (`backend="triton"`). One program owns one
128-lane group of one image, and every group of every image in a call
runs in ONE launch: a single Kodak-sized image at lanes 256 is 2
programs, a 32-point grid row 64. Inside a program the scan steps run as
an in-kernel `fori_loop` with the 128 lane states, the word pointer and
the mantissa-byte pointer in registers. Per step:

- symbol resolution: the step's (freq | cum) row (one context per step,
  codec.layout) is loaded as two 64-wide vectors and the symbol is the
  count of cum entries <= slot, computed as a [128, 64] compare-and-sum;
- word consumption: lanes that renormalize read their word by a per-lane
  gather at `ptr + rank`, rank being the in-block exclusive cumsum of the
  renormalize mask (the grouped layout stores each group's words in
  consumption order);
- mantissa: up to MAX_NBYTES bytes per token, gathered the same way at
  `bptr + byte_rank + j`.

Every gather stays inside its group's segment whatever the stream holds:
the pointer is clamped to [0, cap - window] and the in-window offset to
the window, exactly as the twin's `dynamic_slice` windows clamp. A
corrupt or forged stream (say, states that renormalize on every step)
then decodes to the twin's garbage values instead of reading past the
buffer.

The XLA `lax.scan` twin (entropy/grouped.py:decode_grouped) is the
bit-exact reference and the CPU path; tests run this kernel in interpret
mode against it. Streams are read straight from device memory, so the
kernel has no size limit beyond the arrays themselves.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from jxl_jax.entropy.grouped import GROUP, MANT_SLACK, MAX_NBYTES, WORD_SLACK
from jxl_jax.entropy.rans import RANS_L, RANS_M, RANS_PRECISION

ROUTES = ("triton", "xla", "interpret")
# Warps per program (one 128-lane group). Measured on an H100 (rANS stage
# of a Kodak-sized image: 21.5 ms at 4 warps, 17.5 at 8, 16.9 at 16);
# num_stages and masking the gathers changed nothing (PERF.md, PR 1).
NUM_WARPS = 16


def decode_route(platform: str | None = None) -> str:
    """The rANS decoder for a JAX platform: the Triton kernel on `gpu`,
    the XLA scan twin on `cpu`. Any other platform is an error: nothing
    here was written or checked for it. ("interpret", the kernel under
    the Pallas interpreter, is chosen only explicitly, by tests.)"""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no rANS decode route for platform {platform!r}")


def _kernel(
    rows_ref, words_ref, mant_ref, states_ref, ptr_ref,
    out_ref, states_out_ref, ptr_out_ref, *, T: int, G: int, capw: int, capm: int,
):
    gid = pl.program_id(0)  # group of the whole batch: image gid // G
    b = gid // G
    g = gid % G
    k64 = jax.lax.broadcasted_iota(jnp.int32, (GROUP, 64), 1)
    wbase = gid * capw
    mbase = gid * capm

    def step(t, carry):
        x, wp, mp = carry
        f_row = rows_ref[t, b, pl.ds(0, 64)]
        c_row = rows_ref[t, b, pl.ds(64, 64)]
        slot = (x & jnp.uint32(RANS_M - 1)).astype(jnp.int32)
        ge = (slot[:, None] >= c_row[None, :]).astype(jnp.int32)
        sym = jnp.sum(ge, axis=1) - 1
        hit = k64 == sym[:, None]
        f = jnp.sum(jnp.where(hit, f_row[None, :], 0), axis=1)
        bias = jnp.sum(jnp.where(hit, c_row[None, :], 0), axis=1)
        x_dec = f.astype(jnp.uint32) * (x >> RANS_PRECISION) + (
            slot - bias
        ).astype(jnp.uint32)
        need = (x_dec < RANS_L).astype(jnp.int32)
        rank = jnp.cumsum(need) - need
        w = words_ref[wbase + jnp.clip(wp, 0, capw - WORD_SLACK) + rank]
        x_new = jnp.where(need == 1, (x_dec << 16) | w, x_dec)

        nbits = jnp.where(sym >= 32, sym - 27, 0)
        nbyt = (nbits + 7) >> 3
        brank = jnp.cumsum(nbyt) - nbyt
        mwin = mbase + jnp.clip(mp, 0, capm - MANT_SLACK)
        mval = jnp.zeros((GROUP,), jnp.uint32)
        for j in range(MAX_NBYTES):
            byte = mant_ref[mwin + jnp.minimum(brank + j, MANT_SLACK - 1)]
            mval = mval | jnp.where(j < nbyt, byte << jnp.uint32(8 * j), 0).astype(
                jnp.uint32
            )
        value = jnp.where(
            sym >= 32,
            (jnp.uint32(1) << nbits.astype(jnp.uint32)) + mval,
            sym.astype(jnp.uint32),
        )
        out_ref[b, t, pl.ds(g * GROUP, GROUP)] = value
        return x_new, wp + jnp.sum(need), mp + jnp.sum(nbyt)

    x0 = states_ref[gid, :]
    x, wp, mp = jax.lax.fori_loop(0, T, step, (x0, ptr_ref[0, gid], ptr_ref[1, gid]))
    states_out_ref[gid, :] = x
    ptr_out_ref[0, gid] = wp
    ptr_out_ref[1, gid] = mp


@partial(jax.jit, static_argnames=("T", "lanes", "interpret", "num_warps"))
def decode_grouped_triton(
    words_g, mant_g, states, rows, *, T: int, lanes: int, ptr_init=None,
    interpret: bool = False, num_warps: int = NUM_WARPS,
):
    """Kernel twin of grouped.decode_grouped over B same-geometry streams.

    words_g: [B*G, capw] u32, mant_g: [B*G, capm] u32 (per-group segments
    with >= WORD_SLACK / MANT_SLACK elements of tail slack; gathers are
    clamped to the segment as in the twin); states: [B*G, 128] u32 (an image's lanes are its G
    consecutive rows); rows: [T, B, 128] i32 from grouped.kernel_rows, one
    row stream per image (grid points differ in their tables); ptr_init:
    optional [2, B*G] i32 (word, mantissa) stream pointers carried from a
    previous phase (container v8's two-phase decode), zeros otherwise.

    Returns (values [B, T*lanes] u32, final states [B*G, 128] u32, final
    pointers [2, B*G] i32): the carry feeds the next phase."""
    G = lanes // GROUP
    Gt, capw = words_g.shape
    capm = mant_g.shape[1]
    B = rows.shape[1]
    assert Gt == B * G and states.shape == (Gt, GROUP), (Gt, B, G, states.shape)
    assert capw >= WORD_SLACK and capm >= MANT_SLACK, (capw, capm)
    if ptr_init is None:
        ptr_init = jnp.zeros((2, Gt), jnp.int32)
    out, st_f, ptr_f = pl.pallas_call(
        partial(_kernel, T=T, G=G, capw=capw, capm=capm),
        grid=(Gt,),
        out_shape=[
            jax.ShapeDtypeStruct((B, T, lanes), jnp.uint32),
            jax.ShapeDtypeStruct((Gt, GROUP), jnp.uint32),
            jax.ShapeDtypeStruct((2, Gt), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="rans_decode",
    )(
        rows.astype(jnp.int32),
        words_g.astype(jnp.uint32).reshape(-1),
        mant_g.astype(jnp.uint32).reshape(-1),
        states.astype(jnp.uint32),
        ptr_init.astype(jnp.int32),
    )
    return out.reshape(B, T * lanes), st_f, ptr_f
