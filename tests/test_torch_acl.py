"""The port's ACL engine (``nomad_tpu_torch/acl``, ``structs/acl``) and
the server's ACL entry points, held against the JAX package.

1. The six policy cases of ``tests/test_acl.py`` on the port (its Agent
   cases wait for the agent), then every policy of those cases through
   both parsers and both ACL engines: the parsed policies as plain data,
   errors by type and message, and every capability decision equal.
2. ``Server.bootstrap_acl`` and ``Server.upsert_acl_policies`` on a CPU
   server, equal to the JAX server's; ACL structs through the wire codec
   and an FSM snapshot; ``bootstrap_acl`` on three port servers on
   ``WireRaft`` with the token read back on a follower.
"""
import shutil
import tempfile
import time

import pytest

import nomad_tpu.acl as jacl
import nomad_tpu.structs.acl as jacl_structs
from nomad_tpu.server import Server as JaxServer
from nomad_tpu.server import ServerConfig as JaxServerConfig

from nomad_tpu_torch.acl import (
    ACLResolver,
    PermissionDenied,
    TokenError,
    management_acl,
    new_acl,
    parse_policy,
)
from nomad_tpu_torch.acl.acl import (
    NS_CAP_DENY,
    NS_CAP_LIST_JOBS,
    NS_CAP_READ_JOB,
    NS_CAP_SUBMIT_JOB,
)
from nomad_tpu_torch.jobspec.hcl import HCLError
from nomad_tpu_torch.rpc import RPCServer, decode, encode
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.wire_raft import (
    LEADER,
    WireRaft,
    WireRaftConfig,
    _decode_fsm_state,
    _encode_fsm_state,
)
from nomad_tpu_torch.structs import acl as acl_structs
from test_torch_jobspec import outcome, plain


def wait_until(fn, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


# -- 1. tests/test_acl.py's policy cases on the port ------------------------


SHORTHANDS = """
    namespace "default" {
      policy = "read"
    }
    namespace "ops" {
      policy       = "write"
      capabilities = ["sentinel-override"]
    }
    node     { policy = "write" }
    agent    { policy = "read" }
    operator { policy = "deny" }
    """


def test_parse_policy_shorthands():
    pol = parse_policy(SHORTHANDS)
    assert len(pol.namespaces) == 2
    default = pol.namespaces[0]
    assert default.name == "default"
    assert NS_CAP_LIST_JOBS in default.capabilities
    assert NS_CAP_READ_JOB in default.capabilities
    assert NS_CAP_SUBMIT_JOB not in default.capabilities
    ops = pol.namespaces[1]
    assert NS_CAP_SUBMIT_JOB in ops.capabilities
    assert "sentinel-override" in ops.capabilities
    assert pol.node == "write"
    assert pol.agent == "read"
    assert pol.operator == "deny"


BAD_POLICIES = [
    'namespace "x" { policy = "admin" }',
    'namespace "x" { capabilities = ["fly"] }',
    'widget "x" { policy = "read" }',
    'namespace "x" { }',  # grants nothing
]


def test_parse_policy_errors():
    for src in BAD_POLICIES:
        with pytest.raises(HCLError):
            parse_policy(src)


def test_acl_merge_deny_wins():
    read = parse_policy('namespace "default" { policy = "read" }')
    deny = parse_policy('namespace "default" { policy = "deny" }')
    write = parse_policy('namespace "default" { policy = "write" }')
    acl = new_acl([read, write])
    assert acl.allow_namespace_operation("default", NS_CAP_SUBMIT_JOB)
    acl = new_acl([read, deny, write])
    assert not acl.allow_namespace_operation("default", NS_CAP_READ_JOB)
    assert not acl.allow_namespace("default")


def test_acl_coarse_merge_and_management():
    a = parse_policy("node { policy = \"read\" }")
    b = parse_policy("node { policy = \"write\" }")
    acl = new_acl([a, b])
    assert acl.allow_node_write() and acl.allow_node_read()
    deny = parse_policy("node { policy = \"deny\" }")
    acl = new_acl([a, b, deny])
    assert not acl.allow_node_read()
    m = management_acl()
    assert m.allow_node_write() and m.allow_operator_write()
    assert m.allow_namespace_operation("anything", NS_CAP_SUBMIT_JOB)


def test_acl_namespace_glob():
    pol = parse_policy('namespace "prod-*" { policy = "read" }')
    acl = new_acl([pol])
    assert acl.allow_namespace_operation("prod-web", NS_CAP_READ_JOB)
    assert not acl.allow_namespace_operation("dev", NS_CAP_READ_JOB)


def test_host_volume_policy():
    pol = parse_policy('host_volume "data-*" { policy = "write" }')
    acl = new_acl([pol])
    assert acl.allow_host_volume_operation("data-1", "mount-readwrite")
    assert not acl.allow_host_volume_operation("other", "mount-readonly")


# -- the port against the JAX engine -----------------------------------------


POLICIES = {
    "shorthands": SHORTHANDS,
    "read": 'namespace "default" { policy = "read" }',
    "deny": 'namespace "default" { policy = "deny" }',
    "write": 'namespace "default" { policy = "write" }',
    "node_read": 'node { policy = "read" }',
    "node_write": 'node { policy = "write" }',
    "node_deny": 'node { policy = "deny" }',
    "glob": 'namespace "prod-*" { policy = "read" }',
    "host_volume": 'host_volume "data-*" { policy = "write" }',
    "caps": 'namespace "ops" { capabilities = ["submit-job", "read-logs"] }',
}
POLICIES.update({f"bad_{i}": src for i, src in enumerate(BAD_POLICIES)})

MERGES = [("read", "write"), ("read", "deny", "write"), ("node_read", "node_write"),
          ("node_read", "node_write", "node_deny"), ("glob",), ("host_volume",),
          ("shorthands",), ("caps", "read")]
NAMESPACES = ["default", "ops", "prod-web", "dev", "prod-"]
CAPS = [NS_CAP_DENY, NS_CAP_LIST_JOBS, NS_CAP_READ_JOB, NS_CAP_SUBMIT_JOB, "read-logs",
        "sentinel-override"]


def decisions(acl):
    out = {"node": (acl.allow_node_read(), acl.allow_node_write()),
           "operator": (acl.allow_operator_read(), acl.allow_operator_write()),
           "agent": (acl.allow_agent_read(), acl.allow_agent_write())}
    for ns in NAMESPACES:
        out[ns] = [acl.allow_namespace(ns)] + [acl.allow_namespace_operation(ns, c)
                                               for c in CAPS]
    for vol in ("data-1", "other"):
        out[vol] = [acl.allow_host_volume_operation(vol, op)
                    for op in ("mount-readonly", "mount-readwrite")]
    return out


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_parse_policy_equals_the_jax_parser(name):
    src = POLICIES[name]
    port, ref = outcome(parse_policy, src), outcome(jacl.parse_policy, src)
    assert port == ref
    assert (port[0] == "error") == name.startswith("bad_")


@pytest.mark.parametrize("names", MERGES, ids=["+".join(m) for m in MERGES])
def test_acl_decisions_equal_the_jax_engine(names):
    port = new_acl([parse_policy(POLICIES[n]) for n in names])
    ref = jacl.new_acl([jacl.parse_policy(POLICIES[n]) for n in names])
    assert decisions(port) == decisions(ref)
    assert decisions(management_acl()) == decisions(jacl.management_acl())


def test_resolver_equals_the_jax_resolver():
    """Tokens resolved against each package's server state: management,
    client with policies, unknown secret."""
    def run(server_cls, cfg, structs, resolver_cls):
        srv = server_cls(cfg)
        try:
            srv.start()
            srv.upsert_acl_policies([structs.ACLPolicy(name="r", rules=POLICIES["read"])])
            boot = srv.bootstrap_acl()
            tok = structs.ACLToken(name="c", type="client", policies=["r"])
            srv.upsert_acl_tokens([tok])
            res = resolver_cls(lambda: srv.fsm.state)
            out = []
            for secret in (boot.secret_id, tok.secret_id, "no-such-secret"):
                try:
                    out.append(decisions(res.resolve_secret(secret)))
                except PermissionError as e:
                    out.append((type(e).__name__, str(e).replace(secret, "<secret>")))
            return out
        finally:
            srv.stop()

    port = run(Server, ServerConfig(device="cpu", num_schedulers=0), acl_structs, ACLResolver)
    ref = run(JaxServer, JaxServerConfig(num_schedulers=0), jacl_structs, jacl.ACLResolver)
    assert port == ref
    assert isinstance(port[2], tuple) and port[2][0] in (TokenError.__name__,
                                                         PermissionDenied.__name__)


# -- 2. the server's ACL entry points ----------------------------------------


TOKEN_FIELDS = ("name", "type", "policies", "global_", "create_index", "modify_index")


def _acl_entry_points(server_cls, cfg, structs):
    srv = server_cls(cfg)
    try:
        srv.start()
        tok = srv.bootstrap_acl()
        again = outcome(srv.bootstrap_acl)
        srv.upsert_acl_policies([
            structs.ACLPolicy(name="readers", rules=POLICIES["read"]),
            structs.ACLPolicy(name="ops", rules=POLICIES["caps"]),
        ])
        bad_rules = outcome(srv.upsert_acl_policies,
                            [structs.ACLPolicy(name="bad", rules=BAD_POLICIES[0])])
        bad_name = outcome(srv.upsert_acl_policies, [structs.ACLPolicy(name="", rules="")])
        state = srv.fsm.state
        stored = state.acl_token_by_accessor(tok.accessor_id)
        return {
            "token": {f: getattr(tok, f) for f in TOKEN_FIELDS},
            "stored": stored.secret_id == tok.secret_id and stored.is_management(),
            "bootstrap_index": state.acl_bootstrap_index,
            "again": again,
            "policies": sorted((p.name, p.rules, p.create_index, p.modify_index)
                               for p in state.acl_policies()),
            "bad_rules": bad_rules,
            "bad_name": bad_name,
        }
    finally:
        srv.stop()


def test_acl_entry_points_equal_the_jax_server():
    port = _acl_entry_points(Server, ServerConfig(device="cpu", num_schedulers=0), acl_structs)
    ref = _acl_entry_points(JaxServer, JaxServerConfig(num_schedulers=0), jacl_structs)
    assert port == ref
    assert port["stored"] and port["token"]["type"] == "management"
    assert port["again"][0] == "error" and port["bad_rules"][0] == "error"
    assert [p[0] for p in port["policies"]] == ["ops", "readers"]


def test_acl_structs_cross_the_codec_and_a_snapshot():
    """Registered in the port's codec: tokens and policies come back as
    their own types, through a frame and through an FSM snapshot, and
    the bytes are the JAX codec's."""
    from nomad_tpu.rpc import codec as jcodec
    from nomad_tpu_torch.state import StateStore

    tok = acl_structs.bootstrap_token()
    pol = acl_structs.ACLPolicy(name="readers", rules=POLICIES["read"])
    for obj in (tok, pol):
        back = decode(encode(obj))
        assert type(back) is type(obj) and back == obj
        ref = jacl_structs.ACLToken if obj is tok else jacl_structs.ACLPolicy
        assert plain(jcodec.decode(encode(obj))) == plain(obj)
        assert type(jcodec.decode(encode(obj))) is ref
    store = StateStore()
    store.upsert_acl_policies(3, [pol])
    store.bootstrap_acl_token(4, tok)
    restored = _decode_fsm_state(_encode_fsm_state(store))
    assert type(restored.acl_token_by_accessor(tok.accessor_id)) is acl_structs.ACLToken
    assert restored.acl_token_by_accessor(tok.accessor_id) == \
        store.acl_token_by_accessor(tok.accessor_id)
    assert restored.acl_token_by_accessor(tok.accessor_id).secret_id == tok.secret_id
    assert restored.acl_policy_by_name("readers") == store.acl_policy_by_name("readers")
    assert restored.acl_bootstrap_index == 4


_ELECTIONS = dict(election_timeout_min=0.3, election_timeout_max=0.6, heartbeat_interval=0.05)


def test_bootstrap_acl_on_a_wire_raft_cluster():
    """Three port servers on WireRaft on the CPU: the bootstrap token
    applied on the leader replicates, and a follower reads it back (as an
    ACLToken, with its secret)."""
    dirs = [tempfile.mkdtemp(prefix="acl-wire-") for _ in range(3)]
    rpcs = [RPCServer() for _ in range(3)]
    rafts = []
    for i, rpc in enumerate(rpcs):
        peers = {f"s{j}": rpcs[j].addr for j in range(3) if j != i}
        rafts.append(WireRaft(rpc, peers, WireRaftConfig(node_id=f"s{i}", **_ELECTIONS),
                              data_dir=dirs[i]))
    servers = [Server(ServerConfig(device="cpu", num_schedulers=0), raft=rafts[i], name=f"s{i}")
               for i in range(3)]
    try:
        for rpc in rpcs:
            rpc.start()
        for s in servers:
            s.start()
        for r in rafts:
            r.start()
        wait_until(lambda: sum(1 for r in rafts if r.state == LEADER) == 1, msg="a leader")
        leader = next(s for s, r in zip(servers, rafts) if r.state == LEADER)
        follower = next(s for s in servers if s is not leader)
        tok = leader.bootstrap_acl()
        wait_until(lambda: follower.fsm.state.acl_token_by_accessor(tok.accessor_id) is not None,
                   msg="the token on a follower")
        got = follower.fsm.state.acl_token_by_accessor(tok.accessor_id)
        assert type(got) is acl_structs.ACLToken
        assert got.secret_id == tok.secret_id and got.is_management()
        assert follower.fsm.state.acl_bootstrap_index == leader.fsm.state.acl_bootstrap_index
        with pytest.raises(ValueError, match="already"):
            leader.bootstrap_acl()
    finally:
        for s in servers:
            s.stop()
        for r in rafts:
            r.close()
        for rpc in rpcs:
            rpc.stop()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
