"""``python -m icar_tpu_torch options.nml [--device cpu] [--profile DIR]``:
a file-driven run of the port (``core/driver.py``), on the card unless
``--device cpu``."""

import sys

from .core.driver import main

if __name__ == "__main__":
    sys.exit(main())
