"""Standalone wire-raft server process for the crash-recovery harness.

``python -m nomad_tpu_torch.chaos.crash_server --node-id s0 --rpc-port 7101
--peers s1=127.0.0.1:7102,s2=127.0.0.1:7103 --data-dir /tmp/s0`` boots
one full server — RPC transport on a FIXED port, ``WireRaft`` with
durable log/meta/snapshot under ``data_dir``, ``Server`` runtime, the
whole endpoint surface — and then blocks until SIGTERM (clean shutdown)
or SIGKILL (the point of the exercise: no shutdown path runs, recovery
must come from what already hit the disk).

Fixed ports matter: the harness preallocates the port map so a killed
node restarts at the SAME address and its peers' replicator connections
re-target without gossip. The scheduler runs the host (``binpack``)
path — one JAX compile storm per subprocess would dwarf every timing
this harness measures, and kernel parity has its own suite.

Prints ``READY <node-id> <host>:<port>`` on stdout once serving.

Copied from ``nomad_tpu/chaos/crash_server.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; run it as ``python -m
nomad_tpu_torch.chaos.crash_server``. One change: ``--device`` (default
``cuda``) is the ``ServerConfig.device`` of the process, the port's way
to ask for the CPU (``--device cpu``). The host ``binpack`` scheduler
stays as the reference has it, so the process's placements run on the
host whatever the device, and nothing initialises CUDA in it (the
``DeviceBatcher`` pins its slab and makes its events at its first
batch). The reason given above, a JAX compile per process, does not
hold for the port; whether the harness should place on the card is left
open, since it would change what the harness measures. A process that
cannot build or load the native log exits non-zero.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Dict, Tuple


def parse_peers(spec: str) -> Dict[str, Tuple[str, int]]:
    """``id=host:port,id=host:port`` → peer map."""
    peers: Dict[str, Tuple[str, int]] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        pid, addr = part.split("=", 1)
        host, port = addr.rsplit(":", 1)
        peers[pid] = (host, int(port))
    return peers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nomad_tpu_torch.chaos.crash_server")
    p.add_argument("--node-id", required=True)
    p.add_argument("--rpc-port", type=int, required=True)
    p.add_argument("--peers", default="",
                   help="other cluster members as id=host:port,...")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--election-min", type=float, default=0.3)
    p.add_argument("--election-max", type=float, default=0.6)
    p.add_argument("--raft-heartbeat", type=float, default=0.06)
    p.add_argument("--num-schedulers", type=int, default=2)
    # node TTLs sit well above the election gap so a failover never
    # spuriously expires the fleet mid-measurement
    p.add_argument("--heartbeat-min-ttl", type=float, default=4.0)
    p.add_argument("--heartbeat-max-ttl", type=float, default=6.0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the server (cuda, or cpu)")
    args = p.parse_args(argv)

    from ..rpc.endpoints import bind_server
    from ..rpc.transport import RPCServer
    from ..server.server import Server, ServerConfig
    from ..server.wire_raft import WireRaft, WireRaftConfig
    from ..trace import context as xtrace

    # nomad-xtrace: stamp this replica's node id on every span it
    # records, and spill spans to the data dir (append + flush per span)
    # so a SIGKILL loses nothing already written — the collector's
    # Trace.Export drain is the fast path, the spill is the black box
    import os

    xtrace.set_process(args.node_id)
    xtrace.configure_spill(os.path.join(args.data_dir, "spans.jsonl"))

    peers = parse_peers(args.peers)
    rpc = RPCServer(host="127.0.0.1", port=args.rpc_port)
    raft = WireRaft(
        rpc, peers,
        WireRaftConfig(
            node_id=args.node_id,
            election_timeout_min=args.election_min,
            election_timeout_max=args.election_max,
            heartbeat_interval=args.raft_heartbeat,
            rpc_timeout=0.5,
            apply_timeout=10.0,
        ),
        data_dir=args.data_dir,
    )
    config = ServerConfig(
        num_schedulers=args.num_schedulers,
        heartbeat_min_ttl=args.heartbeat_min_ttl,
        heartbeat_max_ttl=args.heartbeat_max_ttl,
        eval_gc_interval=3600.0,
        scheduler_algorithm="binpack",
        device=args.device,
    )
    server = Server(config, raft=raft, name=args.node_id)
    bind_server(server, rpc)

    # transparent write forwarding: followers answer reads locally and
    # forward writes to whoever raft says leads (static port map, so the
    # address is computable without gossip)
    addr_map: Dict[str, Tuple[str, int]] = dict(peers)
    addr_map[args.node_id] = ("127.0.0.1", args.rpc_port)
    rpc.is_leader = raft.is_leader  # race-ok: set before rpc.start(); no dispatch thread exists yet
    stop = threading.Event()

    def leader_addr_loop() -> None:
        while not stop.wait(0.1):
            lid = raft.leader_id
            rpc.leader_addr = addr_map.get(lid) if lid else None

    def on_sigterm(signum, frame) -> None:
        stop.set()

    signal.signal(signal.SIGTERM, on_sigterm)
    rpc.start()
    server.start()
    raft.start()
    threading.Thread(target=leader_addr_loop, name="leader-addr",
                     daemon=True).start()
    host, port = rpc.addr
    print(f"READY {args.node_id} {host}:{port}", flush=True)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        server.stop()
        raft.close()
        rpc.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
