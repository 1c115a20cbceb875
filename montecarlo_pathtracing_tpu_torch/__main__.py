"""`python -m montecarlo_pathtracing_tpu_torch`: the command-line renderer
(cli.py). Importing this module runs nothing."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
