"""``python -m oryx_tpu_torch.analysis`` — run oryxlint over the port."""

import sys

from oryx_tpu_torch.analysis.core import main

if __name__ == "__main__":
    sys.exit(main())
