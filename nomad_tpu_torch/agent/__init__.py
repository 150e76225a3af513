"""HTTP agent: embeds a server and/or client and serves the /v1 API.

Fills the role of the reference's ``command/agent`` package (agent.go:90
NewAgent, http.go:150 registerHandlers).

Copied from ``nomad_tpu/agent/__init__.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change.
"""

from .agent import Agent, AgentConfig
from .http import HTTPServer

__all__ = ["Agent", "AgentConfig", "HTTPServer"]
