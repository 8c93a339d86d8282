from jxl_jax.cli.main import main

raise SystemExit(main())
