"""``python -m nomad_tpu_torch.cli``: the CLI's entry point.

Copied from ``nomad_tpu/cli/__main__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""
import sys

from .main import main

sys.exit(main())
