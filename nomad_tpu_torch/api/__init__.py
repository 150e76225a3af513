"""Standalone HTTP API SDK (reference api/ package — importable without the
rest of the framework; stdlib-only).

Copied from ``nomad_tpu/api/__init__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""

from .api import (
    APIError,
    Client,
    Config,
    QueryMeta,
    QueryOptions,
    WriteMeta,
    WriteOptions,
)

__all__ = [
    "APIError",
    "Client",
    "Config",
    "QueryMeta",
    "QueryOptions",
    "WriteMeta",
    "WriteOptions",
]
