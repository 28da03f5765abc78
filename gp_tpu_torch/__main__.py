"""``python -m gp_tpu_torch`` runs the CLI (cli.py)."""

import sys

from .cli import main

sys.exit(main())
