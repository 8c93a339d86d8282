from jxl_jax.distributed.mesh import make_mesh  # noqa: F401
