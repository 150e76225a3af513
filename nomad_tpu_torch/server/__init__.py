"""Server runtime (reference nomad/): raft/FSM, broker, planner, workers.

Copied from ``nomad_tpu/server/__init__.py``
into the PyTorch port, which imports nothing of ``nomad_tpu``.
"""
from .eval_broker import EvalBroker  # noqa: F401
from .blocked_evals import BlockedEvals  # noqa: F401
from .fsm import NomadFSM  # noqa: F401
from .plan_apply import Planner, PlanQueue  # noqa: F401
from .raft import InProcRaft  # noqa: F401
from .server import Server, ServerConfig  # noqa: F401
from .worker import Worker  # noqa: F401
