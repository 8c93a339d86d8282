from jxl_jax.entropy.rans import (  # noqa: F401
    RANS_PRECISION,
    rans_encode,
    rans_decode,
    quantize_histograms,
)
from jxl_jax.entropy.tokens import (  # noqa: F401
    tokenize,
    detokenize,
    pack_bits,
    unpack_bits,
)
