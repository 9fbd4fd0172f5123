"""``python -m devspace_tpu_torch`` entry point: the port's CLI
(``cli/main.py``; reference: main.go -> cmd.Execute)."""

import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
