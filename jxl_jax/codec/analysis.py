"""Stable analysis entry points for the measurement tools.

The tools under `tools/` (bit_breakdown, combo_study, ctx_study,
nnz_study, profile_codec, ...) need the encoder's intermediate token
stream without the entropy/packing tail. They previously imported the
private `codec.encode._encode_stage1`, which made every encoder refactor
silently break the measurement tooling the round verdicts depend on.
This module is the supported surface: the signature below is stable, and
`tests/test_tools_smoke.py` pins both it and the tools that consume it.
"""

from __future__ import annotations

from functools import partial

import jax

from jxl_jax.codec.encode import tokens_from_rgb

# jitted stage-1 encoder: pixels -> (token, nbits, mantissa, params,
# q_sorted). `distance` is traced; geometry/effort/hooks are static.
encode_tokens_for_analysis = partial(
    jax.jit,
    static_argnames=("height", "width", "effort", "hook_a", "hook_b"),
)(tokens_from_rgb)
