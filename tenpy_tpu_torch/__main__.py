"""``python -m tenpy_tpu_torch params.yml``: run a simulation from YAML
parameter files (:func:`tenpy_tpu_torch.console_main`)."""
import sys

from . import console_main

if __name__ == '__main__':
    sys.exit(console_main())
