from jxl_jax.native.bindings import (  # noqa: F401
    available,
    rans_encode_native,
    rans_decode_native,
    pack_bits_native,
    unpack_bits_native,
)
