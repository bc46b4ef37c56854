"""Entry point: ``python -m fakepta_tpu_torch.obs summarize|compare|trace``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
