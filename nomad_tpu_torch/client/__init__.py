"""Client agent (reference ``client/``): node runtime executing allocations.

Copied from ``nomad_tpu/client/__init__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``.
"""
from .allocdir import AllocDir, TaskDir
from .allocrunner import AllocRunner
from .client import Client, ClientConfig, ServerProxy
from .fingerprint import fingerprint_node
from .taskenv import TaskEnvBuilder
from .taskrunner import TaskRunner

# importing registers the built-in drivers
from .drivers import base as _base  # noqa: F401
from .drivers import exec_driver as _exec  # noqa: F401
from .drivers import mock_driver as _mock  # noqa: F401
from .drivers import raw_exec as _raw_exec  # noqa: F401

__all__ = [
    "AllocDir",
    "AllocRunner",
    "Client",
    "ClientConfig",
    "ServerProxy",
    "TaskDir",
    "TaskEnvBuilder",
    "TaskRunner",
    "fingerprint_node",
]
