"""E2E suites over real agent processes, the cluster half of
``tests/test_e2e.py`` on the port (``TestClusterOpsE2E``,
``TestServerFailoverE2E``): config-file boot, gossip join and key
rotation, force-leave, client GC, and a leader's SIGKILL on three wire
raft servers, every agent the port's CLI on the CPU. The single-agent
suites are in ``tests/test_torch_e2e.py``.
"""
import os
import time

from torch_e2e_framework import (
    AgentProc,
    allocs_of,
    running_allocs,
    service_job,
    wait_until,
)


class TestClusterOpsE2E:
    """Config-file boot + runtime join + key rotation + force-leave +
    client GC, over REAL forked agent processes (VERDICT r3 #4/#6 e2e
    criteria; reference e2e slots for agent config and cluster ops)."""

    def test_config_boot_join_rotate_forceleave_gc(self, tmp_path):
        import base64
        import secrets as _secrets
        import socket

        def free_port(k):
            # OUTSIDE the kernel's ephemeral range (and pid-scattered), so
            # the agents' own ephemeral http/rpc binds can't steal a
            # reserved port in the boot window (bind TOCTOU)
            for attempt in range(50):
                p = 21000 + (os.getpid() * 13 + k * 7919 + attempt) % 9000
                s = socket.socket()
                try:
                    s.bind(("127.0.0.1", p))
                    return p
                except OSError:
                    continue
                finally:
                    s.close()
            raise RuntimeError("no free fixed port found")

        key_a = base64.b64encode(_secrets.token_bytes(32)).decode()
        key_b = base64.b64encode(_secrets.token_bytes(32)).decode()
        serf1, serf2 = free_port(1), free_port(2)

        def write_cfg(name, serf_port, client=False):
            p = tmp_path / f"{name}.hcl"
            p.write_text(f'''
name       = "{name}"
datacenter = "dc1"
ports {{
  http = 0
  serf = {serf_port}
}}
server {{
  enabled          = true
  bootstrap_expect = 1
  encrypt          = "{key_a}"
}}
client {{
  enabled = {"true" if client else "false"}
}}
''')
            return str(p)

        # both agents boot from CONFIG FILES; no retry_join — they meet
        # via the runtime /v1/agent/join endpoint
        a1 = AgentProc("-config", write_cfg("ops1", serf1, client=True),
                       "-dev", name="ops1")
        a2 = AgentProc("-config", write_cfg("ops2", serf2), name="ops2")
        try:
            api1, api2 = a1.api, a2.api
            # config file took effect (name flows into gossip identity)
            wait_until(lambda: api1.agent.members()["Members"][0]["Name"]
                       .startswith("ops1"), msg="config-file name visible")

            # runtime join
            out = api1.agent.join([f"127.0.0.1:{serf2}"])
            assert out["num_joined"] == 1
            wait_until(lambda: len(api1.agent.members()["Members"]) == 2,
                       msg="runtime join converged on 1")
            wait_until(lambda: len(api2.agent.members()["Members"]) == 2,
                       msg="runtime join converged on 2")

            # cluster-wide key rotation from ONE node's endpoint
            api1.agent.keyring_op("install", key_b)
            wait_until(lambda: key_b in api2.agent.keyring_list()["Keys"],
                       msg="install propagated to 2")
            api1.agent.keyring_op("use", key_b)
            wait_until(lambda: key_b in api2.agent.keyring_list()["PrimaryKeys"],
                       msg="use propagated to 2")
            api1.agent.keyring_op("remove", key_a)
            wait_until(lambda: list(api2.agent.keyring_list()["Keys"])
                       == [key_b], msg="remove propagated to 2")
            # gossip still alive post-rotation
            time.sleep(1.0)
            assert len(api1.agent.members()["Members"]) == 2

            # run a short batch task on the dev agent's client, then GC it
            job = service_job("e2e-gc", count=1, command="true")
            job["Type"] = "batch"
            api1.jobs.register(job)
            wait_until(lambda: any(
                a["ClientStatus"] == "complete"
                for a in allocs_of(api1, "e2e-gc")), timeout=180,
                msg="batch task complete")
            out = api1.agent.client_gc()
            assert out["Collected"] >= 1

            # kill 2's gossip hard, then evict it from 1's view
            a2.kill_hard()
            api1.agent.force_leave("ops2.global")
            wait_until(lambda: any(
                m["Name"] == "ops2.global" and m["Status"] in ("left", "failed")
                for m in api1.agent.members()["Members"]),
                msg="forced member marked left/failed")
        finally:
            a1.stop()
            a2.stop()


class TestServerFailoverE2E:
    """Multi-server black-box failover (VERDICT r4 ask #6; reference
    nomad/testing.go:41 multi-server clusters + testutil/wait.go:85
    WaitForLeader): 3 fork-exec wire-raft server agents + a client
    agent; SIGKILL the leader mid-workload and assert a new leader
    commits the remaining placements with no alloc lost or doubled;
    then `operator raft remove-peer` the corpse and rotate the gossip
    keyring under load."""

    def _free_port(self, k):
        import socket

        for attempt in range(50):
            p = 22000 + (os.getpid() * 17 + k * 6211 + attempt) % 9000
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", p))
                return p
            except OSError:
                continue
            finally:
                s.close()
        raise RuntimeError("no free fixed port found")

    def test_leader_sigkill_failover(self, tmp_path):
        import base64
        import secrets as _secrets

        key_a = base64.b64encode(_secrets.token_bytes(32)).decode()
        key_b = base64.b64encode(_secrets.token_bytes(32)).decode()
        serf = [self._free_port(i) for i in (1, 2, 3)]
        rpc = [self._free_port(i) for i in (4, 5, 6)]

        servers = []
        for i in range(3):
            servers.append(AgentProc(
                "-server", "-wire-raft",
                "-name", f"fo{i}",
                "-bootstrap-expect", "3",
                "-data-dir", str(tmp_path / f"s{i}"),
                "-rpc-port", str(rpc[i]),
                "-serf-port", str(serf[i]),
                "-encrypt", key_a,
                "-retry-join", f"127.0.0.1:{serf[0]}",
                name=f"fo{i}",
            ))
        client = AgentProc(
            "-client", "-no-gossip",
            "-data-dir", str(tmp_path / "c0"),
            "-servers", ",".join(f"127.0.0.1:{p}" for p in rpc),
            name="fo-client",
        )
        try:
            apis = [s.api for s in servers]

            def leader_index():
                for i, api in enumerate(apis):
                    if servers[i].proc.poll() is not None:
                        continue
                    try:
                        if api.status.leader() not in ("", "unknown", None):
                            return i
                    except Exception:  # noqa: BLE001 — mid-election
                        continue
                return None

            wait_until(lambda: leader_index() is not None, timeout=180,
                       msg="initial leader elected")
            li = leader_index()
            follower = apis[(li + 1) % 3]

            # manual-ops mode: autopilot's dead-server cleanup would race
            # the explicit `operator raft remove-peer` exercised below
            apis[li].operator.autopilot_set_configuration(
                {"CleanupDeadServers": False})

            # the client node registers (through any server's HTTP -> RPC
            # forward to the leader)
            wait_until(lambda: any(
                n["Status"] == "ready"
                for n in (follower.nodes.list()[0] or [])),
                timeout=180, msg="client node ready")

            # workload phase 1: committed and placed before the kill
            follower.jobs.register(service_job("fo-pre", count=2,
                                               command="sleep 600"))
            wait_until(lambda: len(running_allocs(follower, "fo-pre")) == 2,
                       timeout=180, msg="pre-failover job running")

            # workload phase 2: registered through the DOOMED leader just
            # before SIGKILL — its evals are committed in raft but may be
            # un-processed; the NEW leader must restore and place them
            leader_api = apis[li]
            for k in range(4):
                leader_api.jobs.register(service_job(
                    f"fo-mid-{k}", count=2, command="sleep 600"))
            servers[li].kill_hard()

            wait_until(lambda: leader_index() is not None and
                       leader_index() != li,
                       timeout=180, msg="new leader elected after SIGKILL")
            survivor = apis[leader_index()]

            try:
                for k in range(4):
                    wait_until(
                        lambda k=k: len(running_allocs(survivor, f"fo-mid-{k}")) == 2,
                        timeout=240, msg=f"fo-mid-{k} placed by the new leader")
            except AssertionError:
                for k in range(4):
                    for a in allocs_of(survivor, f"fo-mid-{k}"):
                        print(f"fo-mid-{k}:", a["Name"], a["DesiredStatus"],
                              a["ClientStatus"])
                        if a["ClientStatus"] == "failed":
                            info, _ = survivor.allocations.info(a["ID"])
                            for task, st in (info.get("TaskStates") or {}).items():
                                for ev in st.get("Events") or []:
                                    print("   event:", task, ev.get("Type"),
                                          ev.get("DisplayMessage"),
                                          ev.get("DriverError", ""))
                evs, _ = survivor.evaluations.list()
                print("evals:", [(e["JobID"], e["Status"]) for e in evs or []])
                nodes, _ = survivor.nodes.list()
                print("nodes:", [(n["Name"], n["Status"]) for n in nodes or []])
                print("client log tail:", "".join(client.lines[-15:]))
                for i, s in enumerate(servers):
                    print(f"server fo{i} log tail:", "".join(s.lines[-10:]))
                raise

            # no alloc lost or doubled: each job holds EXACTLY its count of
            # run-desired allocs, with unique names
            for jid in ["fo-pre"] + [f"fo-mid-{k}" for k in range(4)]:
                allocs = [a for a in allocs_of(survivor, jid)
                          if a["DesiredStatus"] == "run"]
                names = [a["Name"] for a in allocs]
                assert len(names) == 2, (jid, names)
                assert len(set(names)) == 2, f"duplicate alloc names: {names}"

            # pre-failover allocs survived untouched (no reschedule storm)
            assert len(running_allocs(survivor, "fo-pre")) == 2

            # operator raft remove-peer evicts the corpse from the config
            # (autopilot cleanup disabled above, so it's still there)
            cfg, _ = survivor.operator.raft_get_configuration()
            dead = [s for s in cfg["Servers"] if s["ID"].startswith(f"fo{li}")]
            assert dead, cfg
            survivor.operator.raft_remove_peer(dead[0]["ID"])
            def peer_gone():
                c, _ = survivor.operator.raft_get_configuration()
                return all(not s["ID"].startswith(f"fo{li}")
                           for s in c["Servers"])
            wait_until(peer_gone, timeout=60, msg="dead peer removed")

            # keyring rotation UNDER LOAD: rotate while a job registers
            survivor.agent.keyring_op("install", key_b)
            survivor.jobs.register(service_job("fo-rotate", count=2,
                                               command="sleep 600"))
            survivor.agent.keyring_op("use", key_b)
            other = apis[(leader_index() + 1) % 3]
            if servers[(leader_index() + 1) % 3].proc.poll() is not None:
                other = apis[(leader_index() + 2) % 3]
            wait_until(lambda: key_b in other.agent.keyring_list()
                       ["PrimaryKeys"], timeout=60,
                       msg="rotation converged on the other survivor")
            survivor.agent.keyring_op("remove", key_a)
            wait_until(lambda: len(running_allocs(survivor, "fo-rotate")) == 2,
                       timeout=240, msg="job placed during rotation")
            # gossip still healthy across survivors after remove
            wait_until(lambda: sum(
                1 for m in survivor.agent.members()["Members"]
                if m["Status"] == "alive") >= 2, timeout=60,
                msg="survivors alive after rotation")
        finally:
            client.stop()
            for s in servers:
                s.stop()
