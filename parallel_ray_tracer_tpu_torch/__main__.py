"""Port of parallel_ray_tracer_tpu/__main__.py: `python -m
parallel_ray_tracer_tpu_torch` runs the CLI (cli.py)."""

from .cli import main

raise SystemExit(main())
