"""`python -m tpu_ecm_torch` == the positional CLI (io/cli.py)."""

from .io.cli import main

raise SystemExit(main())
