"""The `nomad` CLI (reference command/ package).

Copied from ``nomad_tpu/cli/__init__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""

from .main import main

__all__ = ["main"]
