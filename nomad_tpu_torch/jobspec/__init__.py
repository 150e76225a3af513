"""HCL1 jobspec parsing (reference jobspec/ package).

Copied from ``nomad_tpu/jobspec/__init__.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""

from .hcl import HCLError, HCLObject, parse as parse_hcl
from .parse import parse_duration_ns, parse_file, parse_job

__all__ = [
    "HCLError",
    "HCLObject",
    "parse_hcl",
    "parse_duration_ns",
    "parse_file",
    "parse_job",
]
