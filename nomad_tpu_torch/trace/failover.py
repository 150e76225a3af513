"""Failover MTTR tracking: crash-recovery episodes as first-class gauges.

The eval-lifecycle spans (:mod:`.lifecycle`) answer "how slow is the
steady state"; this module answers "how long were we headless". A
failover *episode* starts when a leader dies (SIGKILL in the crash
harness, any abrupt leader loss in production) and collects:

- ``time_to_new_leader_ms`` — kill to a survivor winning a HIGHER term;
- ``time_to_first_commit_ms`` — kill to the first write committed
  through the new leader (the cluster is writable again);
- ``restart_catchup_ms`` — restart of the killed server to its applied
  index reaching the leader's snapshot boundary;
- ``snapshot_installs`` — how many InstallSnapshot rounds the rejoin
  took (>=1 means the compacted-log path was exercised).

Numeric fields are published as ``nomad.chaos.failover.<field>`` gauges
next to the ``nomad.trace.*`` family, so ``/v1/metrics`` carries
recovery MTTR the same way it carries tail latency, and
:class:`nomad_tpu_torch.chaos.slo.SLOGate` can bound them.

Copied from ``nomad_tpu/trace/failover.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. No change but this paragraph.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..utils import metric_names
from ..utils.lock_witness import module_witness_lock

_MAX_EPISODES = 64

_lock = module_witness_lock("failover._lock")
_episodes: List[Dict[str, object]] = []


def _publish(fields: Dict[str, object]) -> None:
    metric_names.publish_family("nomad.chaos.failover", fields)


def record(**fields) -> Dict[str, object]:
    """Open a new failover episode with whatever is known so far (``None``
    values are dropped); returns the episode dict."""
    ep = {k: v for k, v in fields.items() if v is not None}
    with _lock:
        _episodes.append(ep)
        del _episodes[:-_MAX_EPISODES]
    _publish(ep)
    return ep


def note(**fields) -> Dict[str, object]:
    """Merge late-arriving fields into the latest episode (restart
    catch-up is measured long after the election numbers)."""
    add = {k: v for k, v in fields.items() if v is not None}
    with _lock:
        if not _episodes:
            _episodes.append({})
        ep = _episodes[-1]
        ep.update(add)
        out = dict(ep)
    _publish(add)
    return out


def latest() -> Optional[Dict[str, object]]:
    with _lock:
        return dict(_episodes[-1]) if _episodes else None


def episodes() -> List[Dict[str, object]]:
    with _lock:
        return [dict(ep) for ep in _episodes]


def summary() -> Dict[str, object]:
    with _lock:
        eps = [dict(ep) for ep in _episodes]
    return {"episodes": len(eps), "last": eps[-1] if eps else None}


def reset() -> None:
    with _lock:
        _episodes.clear()
