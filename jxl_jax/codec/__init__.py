from jxl_jax.codec.config import CodecConfig, Strategy  # noqa: F401
from jxl_jax.codec.encode import encode_image  # noqa: F401
from jxl_jax.codec.decode import decode_bytes  # noqa: F401
