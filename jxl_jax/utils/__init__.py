from jxl_jax.utils.fs import exists_or_create_dir, dir_exists  # noqa: F401
