"""`python -m druid_tpu_torch <command>`: the CLI (cli.py)."""
import sys

from druid_tpu_torch.cli import main

sys.exit(main())
