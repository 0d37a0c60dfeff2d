"""``python -m gfedntm_tpu_torch``: the port's command line
(:mod:`gfedntm_tpu_torch.cli`), the counterpart of ``python main.py``."""

import sys

from gfedntm_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
