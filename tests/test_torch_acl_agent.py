"""The Agent cases of ``tests/test_acl.py`` on the port: ACL enforcement
over a live dev agent's HTTP API (reference nomad/acl_endpoint_test.go),
the agent on the CPU. The policy and engine cases are in
``tests/test_torch_acl.py``."""

import json
import urllib.error
import urllib.request

import pytest

from nomad_tpu_torch.agent import Agent, AgentConfig


def call(base, path, method="GET", body=None, token=None):
    data = None
    if body is not None:
        data = json.dumps(body).encode()
    headers = {"X-Nomad-Token": token} if token else {}
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
    with urllib.request.urlopen(req, timeout=30) as resp:
        payload = resp.read().decode()
        return json.loads(payload) if payload else None


def call_err(base, path, **kw):
    with pytest.raises(urllib.error.HTTPError) as ei:
        call(base, path, **kw)
    return ei.value.code


# ---------------------------------------------------------------------------
# HTTP enforcement over a live agent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def acl_agent():
    a = Agent(
        AgentConfig(device="cpu",
            dev_mode=True,
            num_schedulers=1,
            acl_enabled=True,
            name="acl-dev",
        )
    )
    a.start()
    yield a
    a.shutdown()


@pytest.fixture(scope="module")
def root_token(acl_agent):
    out = call(acl_agent.http_addr, "/v1/acl/bootstrap", method="POST")
    assert out["Type"] == "management"
    assert out["SecretID"]
    return out["SecretID"]


def test_anonymous_denied(acl_agent, root_token):
    assert call_err(acl_agent.http_addr, "/v1/jobs") == 403


def test_bootstrap_only_once(acl_agent, root_token):
    assert call_err(acl_agent.http_addr, "/v1/acl/bootstrap", method="POST") == 400


def test_management_token_allows(acl_agent, root_token):
    jobs = call(acl_agent.http_addr, "/v1/jobs", token=root_token)
    assert jobs == []


def test_policy_token_lifecycle(acl_agent, root_token):
    base = acl_agent.http_addr
    # create a read-only policy
    call(
        base,
        "/v1/acl/policy/readonly",
        method="PUT",
        body={
            "Name": "readonly",
            "Description": "read only",
            "Rules": 'namespace "default" { policy = "read" }',
        },
        token=root_token,
    )
    pols = call(base, "/v1/acl/policies", token=root_token)
    assert [p["Name"] for p in pols] == ["readonly"]

    # bad rules are rejected
    assert (
        call_err(
            base,
            "/v1/acl/policy/bad",
            method="PUT",
            body={"Name": "bad", "Rules": 'namespace "x" { policy = "nope" }'},
            token=root_token,
        )
        == 400
    )

    # mint a client token bound to the policy
    tok = call(
        base,
        "/v1/acl/token",
        method="PUT",
        body={"Name": "ro", "Type": "client", "Policies": ["readonly"]},
        token=root_token,
    )
    secret = tok["SecretID"]
    assert secret and tok["AccessorID"]

    # token can read but not write
    assert call(base, "/v1/jobs", token=secret) == []
    err = call_err(
        base,
        "/v1/jobs",
        method="PUT",
        body={"Job": {"ID": "x", "TaskGroups": []}},
        token=secret,
    )
    assert err == 403

    # node writes denied too (no node policy)
    assert call_err(base, "/v1/system/gc", method="PUT", token=secret) in (403, 405)

    # token self
    me = call(base, "/v1/acl/token/self", token=secret)
    assert me["AccessorID"] == tok["AccessorID"]

    # management-only endpoints reject client tokens
    assert call_err(base, "/v1/acl/tokens", token=secret) == 403

    # token listing never leaks secrets
    toks = call(base, "/v1/acl/tokens", token=root_token)
    assert all(t["SecretID"] == "" for t in toks)

    # delete the token; it stops resolving
    call(
        base,
        f"/v1/acl/token/{tok['AccessorID']}",
        method="DELETE",
        token=root_token,
    )
    assert call_err(base, "/v1/jobs", token=secret) == 403


def test_bad_token_rejected(acl_agent, root_token):
    assert call_err(acl_agent.http_addr, "/v1/jobs", token="not-a-real-secret") == 403
