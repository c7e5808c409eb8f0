"""``python -m proovread_tpu_torch`` — the CLI entry point."""

import sys

from proovread_tpu_torch.cli import main

sys.exit(main())
