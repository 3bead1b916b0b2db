"""``python -m cluster_generator_tpu_torch`` entry point."""

import sys

from .cli import main

if __name__ == "__main__":  # tools that import this module (pytest
    sys.exit(main())        # --pyargs, pkgutil walks) must not run the CLI
