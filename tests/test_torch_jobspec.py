"""The port's jobspec parser (``nomad_tpu_torch/jobspec``) held against
the JAX package's (``nomad_tpu/jobspec``).

Every case of ``tests/test_jobspec.py`` runs here twice: its own
assertions on the port's parse, and the same source through both parsers,
the results compared as plain data (type names, field names and values,
errors by type and message).
"""
import dataclasses
import textwrap

import pytest

import nomad_tpu.jobspec as jjobspec
from nomad_tpu_torch.jobspec import HCLError, parse_duration_ns, parse_hcl, parse_job
from nomad_tpu_torch.jobspec.hcl import HCLObject


def plain(obj):
    """A struct tree as plain data: dataclasses as their type name and
    fields, HCL objects as their items, containers element by element."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__type": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = plain(getattr(obj, f.name))
        return out
    if type(obj).__name__ == "HCLObject":
        return {"__hcl": [[k, plain(v)] for k, v in obj.items]}
    if isinstance(obj, dict):
        return {k if isinstance(k, (str, int)) else repr(plain(k)): plain(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, set):
        return sorted(plain(v) for v in obj)
    return obj


def outcome(fn, *args):
    """``fn(*args)`` as plain data, or the error it raised (type name and
    message)."""
    try:
        return ("ok", plain(fn(*args)))
    except Exception as e:  # noqa: BLE001 - the error is the result compared
        return ("error", type(e).__name__, str(e))


BASIC = r'''
# A full-surface jobspec, mirroring jobspec/test-fixtures/basic.hcl
job "binstore-storagelocker" {
  region       = "fooregion"
  namespace    = "foonamespace"
  type         = "batch"
  priority     = 52
  all_at_once  = true
  datacenters  = ["us2", "eu1"]

  meta {
    foo = "bar"
  }

  constraint {
    attribute = "kernel.os"
    value     = "windows"
  }

  constraint {
    distinct_hosts = true
  }

  affinity {
    attribute = "${meta.team}"
    value     = "mobile"
    operator  = "="
    weight    = 50
  }

  spread {
    attribute = "${meta.rack}"
    weight    = 100
    target "r1" {
      percent = 40
    }
    target "r2" {
      percent = 60
    }
  }

  update {
    stagger            = "60s"
    max_parallel       = 2
    health_check       = "task_states"
    min_healthy_time   = "10s"
    healthy_deadline   = "10m"
    progress_deadline  = "10m"
    auto_revert        = true
    auto_promote       = false
    canary             = 1
  }

  periodic {
    cron             = "*/5 * * *"
    prohibit_overlap = true
  }

  group "binsl" {
    count = 5

    restart {
      attempts = 5
      interval = "10m"
      delay    = "15s"
      mode     = "delay"
    }

    reschedule {
      attempts       = 5
      interval       = "12h"
      delay          = "30s"
      delay_function = "exponential"
      max_delay      = "120s"
      unlimited      = false
    }

    ephemeral_disk {
      sticky  = true
      size    = 150
      migrate = true
    }

    network {
      mode = "bridge"
      port "http" {}
      port "admin" {
        static = 8080
        to     = 8081
      }
    }

    volume "foo" {
      type   = "host"
      source = "/path"
    }

    meta {
      elb_mode = "tcp"
    }

    task "binstore" {
      driver = "docker"
      user   = "bob"
      leader = true
      kill_timeout = "22s"
      kill_signal  = "SIGQUIT"

      config {
        image = "hashicorp/binstore"
        labels {
          FOO = "bar"
        }
      }

      env {
        HELLO = "world"
        LOREM = "ipsum"
      }

      service {
        port = "http"
        tags = ["foo", "bar"]
      }

      resources {
        cpu    = 500
        memory = 128

        network {
          mbits = 100
          port "one" {
            static = 1
          }
          port "three" {
            static = 3
          }
          port "http" {}
        }

        device "nvidia/gpu" {
          count = 10
          constraint {
            attribute = "${device.attr.memory}"
            value     = "2GB"
            operator  = ">"
          }
          affinity {
            attribute = "${device.model}"
            value     = "1080ti"
            weight    = 50
          }
        }
      }

      artifact {
        source = "http://foo.com/artifact"
        options {
          checksum = "md5:b8a4f3f72ecab0510a6a31e997461c5f"
        }
      }

      template {
        source      = "foo.tpl"
        destination = "foo.target"
        change_mode = "signal"
      }

      vault {
        policies = ["foo", "bar"]
      }
    }

    task "storagelocker" {
      driver = "docker"
      config {
        image = "hashicorp/storagelocker"
      }
      resources {
        cpu    = 500
        memory = 128
      }
      constraint {
        attribute = "kernel.arch"
        value     = "amd64"
      }
    }
  }
}
'''

CONSTRAINT_SUGAR = textwrap.dedent(
    """
    job "x" {
      constraint {
        attribute = "${attr.kernel.version}"
        version   = ">= 4.0"
      }
      constraint {
        attribute = "${node.class}"
        regexp    = "foo.*"
      }
      constraint {
        attribute    = "${meta.tags}"
        set_contains = "a,b"
      }
      constraint {
        attribute = "${attr.driver.docker}"
        operator  = "is_set"
        is_set    = true
      }
      group "g" { task "t" { driver = "mock" } }
    }
    """
)

BARE_TASK = 'job "j" { task "solo" { driver = "raw_exec" config { command = "true" } } }'

PARAMETERIZED = textwrap.dedent(
    """
    job "j" {
      type = "batch"
      parameterized {
        payload       = "required"
        meta_required = ["one"]
        meta_optional = ["two"]
      }
      group "g" {
        task "t" {
          driver = "mock"
          dispatch_payload {
            file = "foo.json"
          }
        }
      }
    }
    """
)

HEREDOC = (
    'job "j" {\n'
    "  // line comment\n"
    "  /* block\n     comment */\n"
    '  group "g" {\n'
    '    task "t" {\n'
    '      driver = "raw_exec"\n'
    "      config {\n"
    "        command = \"bash\"\n"
    "        script = <<-EOF\n"
    "          echo hello\n"
    "          echo world\n"
    "        EOF\n"
    "      }\n"
    "    }\n"
    "  }\n"
    "}\n"
)

INTERPOLATION = ('job "j" { group "g" { task "t" { driver = "mock" '
                 'env { N = "${node.unique.name}" } } } }')

CONNECT = '''
job "countdash" {
  datacenters = ["dc1"]
  group "api" {
    network { mbits = 10 }
    service {
      name = "count-api"
      port = "connect-proxy-count-api"
      connect {
        sidecar_service {
          proxy {
            local_service_port = 9001
          }
        }
        sidecar_task {
          driver = "raw_exec"
        }
      }
    }
    task "web" {
      driver = "mock"
      config { run_for = "10s" }
    }
  }
}
'''

# the GPU job of the port's device path: one nvidia/gpu and one xilinx/fpga
GPU_JOB = '''
job "gpu-train" {
  datacenters = ["dc1"]
  type        = "service"
  group "train" {
    count = 3
    task "trainer" {
      driver = "mock"
      resources {
        cpu    = 100
        memory = 128
        device "nvidia/gpu" { count = 1 }
        device "xilinx/fpga" { count = 1 }
      }
    }
  }
}
'''

JOB_SOURCES = {
    "basic": BASIC,
    "constraint_sugar": CONSTRAINT_SUGAR,
    "bare_task": BARE_TASK,
    "parameterized": PARAMETERIZED,
    "heredoc": HEREDOC,
    "interpolation": INTERPOLATION,
    "connect": CONNECT,
    "gpu_job": GPU_JOB,
    "error_not_a_job": "not a job",
    "error_two_jobs": 'job "a" {} job "b" {}',
    "error_no_tasks": 'job "a" { group "g" {} }',
    "error_duplicate_group": ('job "a" { group "g" { task "t" { driver = "mock" } } '
                              'group "g" { task "t" { driver = "mock" } } }'),
}

HCL_SOURCES = {
    "lists_and_objects": 'nums = [1, 2, 3]\nmixed = ["a", true, 1.5]\nobj = { a = 1, b = "two" }',
    "error_unterminated": 'key = "unterminated',
    "basic": BASIC,
}

DURATIONS = ["10s", "1h30m", "250ms", "1.5h", "-15s", 5000, "10 parsecs", "", "3x"]


# -- the port against the JAX parser, as plain data --------------------------


@pytest.mark.parametrize("name", sorted(JOB_SOURCES))
def test_parse_job_equals_the_jax_parser(name):
    src = JOB_SOURCES[name]
    port, ref = outcome(parse_job, src), outcome(jjobspec.parse_job, src)
    assert port == ref
    assert (port[0] == "error") == name.startswith("error")


@pytest.mark.parametrize("name", sorted(HCL_SOURCES))
def test_parse_hcl_equals_the_jax_parser(name):
    src = HCL_SOURCES[name]
    assert outcome(parse_hcl, src) == outcome(jjobspec.parse_hcl, src)


@pytest.mark.parametrize("value", DURATIONS, ids=[repr(d) for d in DURATIONS])
def test_parse_duration_equals_the_jax_parser(value):
    assert outcome(parse_duration_ns, value) == outcome(jjobspec.parse_duration_ns, value)


def test_connect_hook_equals_the_jax_hook():
    from nomad_tpu.server.job_hooks import job_connect_hook as jhook
    from nomad_tpu_torch.server.job_hooks import job_connect_hook

    port, ref = parse_job(CONNECT), jjobspec.parse_job(CONNECT)
    job_connect_hook(port)
    jhook(ref)
    assert plain(port) == plain(ref)


# -- tests/test_jobspec.py on the port ---------------------------------------


def test_parse_basic_job_level():
    job = parse_job(BASIC)
    assert job.id == "binstore-storagelocker"
    assert job.name == "binstore-storagelocker"
    assert job.region == "fooregion"
    assert job.namespace == "foonamespace"
    assert job.type == "batch"
    assert job.priority == 52
    assert job.all_at_once is True
    assert job.datacenters == ["us2", "eu1"]
    assert job.meta == {"foo": "bar"}

    assert len(job.constraints) == 2
    assert job.constraints[0].ltarget == "kernel.os"
    assert job.constraints[0].rtarget == "windows"
    assert job.constraints[0].operand == "="
    assert job.constraints[1].operand == "distinct_hosts"

    assert len(job.affinities) == 1
    a = job.affinities[0]
    assert (a.ltarget, a.rtarget, a.operand, a.weight) == ("${meta.team}", "mobile", "=", 50)

    assert len(job.spreads) == 1
    sp = job.spreads[0]
    assert sp.attribute == "${meta.rack}"
    assert sp.weight == 100
    assert [(t.value, t.percent) for t in sp.spread_target] == [("r1", 40), ("r2", 60)]

    u = job.update
    assert u.stagger_ns == 60 * 10**9
    assert u.max_parallel == 2
    assert u.health_check == "task_states"
    assert u.auto_revert is True
    assert u.canary == 1

    assert job.periodic.enabled is True
    assert job.periodic.spec == "*/5 * * *"
    assert job.periodic.prohibit_overlap is True


def test_parse_basic_group_and_tasks():
    job = parse_job(BASIC)
    assert len(job.task_groups) == 1
    g = job.task_groups[0]
    assert g.name == "binsl"
    assert g.count == 5
    assert g.restart_policy.attempts == 5
    assert g.restart_policy.interval_ns == 10 * 60 * 10**9
    assert g.restart_policy.mode == "delay"
    assert g.reschedule_policy.delay_function == "exponential"
    assert g.reschedule_policy.max_delay_ns == 120 * 10**9
    assert g.ephemeral_disk.sticky is True
    assert g.ephemeral_disk.migrate is True
    assert g.ephemeral_disk.size_mb == 150
    assert len(g.networks) == 1
    assert g.networks[0].mode == "bridge"
    assert [p.label for p in g.networks[0].dynamic_ports] == ["http"]
    assert [(p.label, p.value, p.to) for p in g.networks[0].reserved_ports] == [
        ("admin", 8080, 8081)
    ]
    assert g.volumes["foo"].source == "/path"
    assert g.meta == {"elb_mode": "tcp"}

    assert [t.name for t in g.tasks] == ["binstore", "storagelocker"]
    t = g.tasks[0]
    assert t.driver == "docker"
    assert t.user == "bob"
    assert t.leader is True
    assert t.kill_timeout_ns == 22 * 10**9
    assert t.kill_signal == "SIGQUIT"
    assert t.config["image"] == "hashicorp/binstore"
    assert t.config["labels"] == {"FOO": "bar"}
    assert t.env == {"HELLO": "world", "LOREM": "ipsum"}
    assert len(t.services) == 1
    assert t.services[0].port_label == "http"
    assert t.services[0].tags == ["foo", "bar"]
    # default service name derives from job/task
    assert "binstore" in t.services[0].name

    r = t.resources
    assert r.cpu == 500 and r.memory_mb == 128
    assert len(r.networks) == 1
    assert r.networks[0].mbits == 100
    assert [(p.label, p.value) for p in r.networks[0].reserved_ports] == [("one", 1), ("three", 3)]
    assert [p.label for p in r.networks[0].dynamic_ports] == ["http"]
    assert len(r.devices) == 1
    d = r.devices[0]
    assert d.name == "nvidia/gpu"
    assert d.count == 10
    assert d.constraints[0].operand == ">"
    assert d.affinities[0].weight == 50

    assert t.artifacts[0]["source"] == "http://foo.com/artifact"
    assert t.artifacts[0]["options"]["checksum"].startswith("md5:")
    assert t.templates[0]["change_mode"] == "signal"
    assert t.templates[0]["splay"] == "5s"  # default
    assert t.vault["policies"] == ["foo", "bar"]
    assert t.vault["env"] is True  # default

    t2 = g.tasks[1]
    assert t2.constraints[0].ltarget == "kernel.arch"


def test_constraint_sugar_operators():
    job = parse_job(CONSTRAINT_SUGAR)
    ops = [c.operand for c in job.constraints]
    assert ops == ["version", "regexp", "set_contains", "is_set"]
    assert job.constraints[0].rtarget == ">= 4.0"
    assert job.constraints[3].rtarget == ""


def test_bare_task_becomes_group():
    job = parse_job(BARE_TASK)
    assert len(job.task_groups) == 1
    assert job.task_groups[0].name == "solo"
    assert job.task_groups[0].count == 1
    assert job.task_groups[0].tasks[0].driver == "raw_exec"


def test_parameterized_and_dispatch_payload():
    job = parse_job(PARAMETERIZED)
    assert job.parameterized.payload == "required"
    assert job.parameterized.meta_required == ["one"]
    assert job.task_groups[0].tasks[0].dispatch_payload_file == "foo.json"


def test_heredoc_and_comments():
    job = parse_job(HEREDOC)
    script = job.task_groups[0].tasks[0].config["script"]
    assert script == "echo hello\necho world\n"


def test_interpolation_preserved():
    job = parse_job(INTERPOLATION)
    assert job.task_groups[0].tasks[0].env["N"] == "${node.unique.name}"


def test_parse_durations():
    assert parse_duration_ns("10s") == 10 * 10**9
    assert parse_duration_ns("1h30m") == 5400 * 10**9
    assert parse_duration_ns("250ms") == 250 * 10**6
    assert parse_duration_ns("1.5h") == 5400 * 10**9
    assert parse_duration_ns("-15s") == -15 * 10**9
    assert parse_duration_ns(5000) == 5000
    with pytest.raises(HCLError):
        parse_duration_ns("10 parsecs")


def test_errors():
    with pytest.raises(HCLError):
        parse_job("not a job")
    with pytest.raises(HCLError):
        parse_job('job "a" {} job "b" {}')
    with pytest.raises(HCLError):
        parse_job('job "a" { group "g" {} }')  # no tasks
    with pytest.raises(HCLError):
        parse_job(JOB_SOURCES["error_duplicate_group"])
    with pytest.raises(HCLError):
        parse_hcl('key = "unterminated')


def test_hcl_lists_and_objects():
    obj = parse_hcl(HCL_SOURCES["lists_and_objects"])
    assert isinstance(obj, HCLObject)
    assert obj.get("nums") == [1, 2, 3]
    assert obj.get("mixed") == ["a", True, 1.5]
    inner = obj.get("obj")
    assert inner.get("a") == 1 and inner.get("b") == "two"


def test_group_service_connect_stanza():
    """Group-level service with a Consul Connect stanza parses into
    Service.connect (parse_service.go parseConnect) and survives the
    register-time sidecar injection hook."""
    job = parse_job(CONNECT)
    tg = job.task_groups[0]
    assert len(tg.services) == 1
    svc = tg.services[0]
    assert svc.name == "count-api"
    assert svc.has_sidecar()
    assert svc.connect["sidecar_service"]["proxy"]["local_service_port"] == 9001
    assert svc.connect["sidecar_task"]["driver"] == "raw_exec"

    from nomad_tpu_torch.server.job_hooks import job_connect_hook

    job_connect_hook(job)
    kinds = [t.kind for t in tg.tasks]
    assert "connect-proxy:count-api" in kinds
    labels = [p.label for p in tg.networks[0].dynamic_ports]
    assert "connect-proxy-count-api" in labels


def test_gpu_job_device_asks():
    """A two-part device name is type/name in the reference
    (``RequestedDevice.id``), not Nomad's vendor/type; the port keeps it,
    and the three-part vendor/type/name means the same in both."""
    job = parse_job(GPU_JOB)
    asks = job.task_groups[0].tasks[0].resources.devices
    assert [(d.name, d.count) for d in asks] == [("nvidia/gpu", 1), ("xilinx/fpga", 1)]
    assert [tuple(vars(d.id()).values()) for d in asks] == [
        ("", "nvidia", "gpu"), ("", "xilinx", "fpga")]
    full = parse_job(GPU_JOB.replace('"nvidia/gpu"', '"nvidia/gpu/NVIDIA H100 80GB HBM3"'))
    ask = full.task_groups[0].tasks[0].resources.devices[0]
    assert tuple(vars(ask.id()).values()) == ("nvidia", "gpu", "NVIDIA H100 80GB HBM3")


# -- Job.Plan: Server.plan_job on the port against the JAX server -------------


PLAN_JOB = '''
job "web" {
  datacenters = ["dc1"]
  group "web" {
    count = 6
    task "frontend" {
      driver = "mock_driver"
      resources {
        cpu    = 250
        memory = 128
      }
    }
  }
}
'''


def _plans(server_cls, cfg, mock_mod, parse):
    """plan_job of a new job (with and without its diff), then, once it
    is registered and placed, of a count change and of a stop."""
    import time as _time

    srv = server_cls(cfg)
    try:
        srv.start()
        for i in range(5):
            n = mock_mod.node()
            n.id = f"00000000-0000-4000-8000-{i:012d}"
            n.name = f"node-{i}"
            n.compute_class()
            srv.register_node(n)
        out = {}
        job = parse(PLAN_JOB)
        out["new"] = plain(srv.plan_job(job))
        out["new_diff"] = plain(srv.plan_job(job, diff=True))
        srv.register_job(parse(PLAN_JOB))
        deadline = _time.monotonic() + 60
        while len([a for a in srv.fsm.state.allocs_by_job("default", "web", True)
                   if a.desired_status == "run"]) < 6:
            assert _time.monotonic() < deadline, "job never placed"
            _time.sleep(0.05)
        assert srv.drain_evals(30.0)
        bigger = parse(PLAN_JOB.replace("count = 6", "count = 9"))
        out["scale"] = plain(srv.plan_job(bigger, diff=True))
        stop = parse(PLAN_JOB)
        stop.stop = True
        out["stop"] = plain(srv.plan_job(stop, diff=True))
        return out
    finally:
        srv.stop()


def _strip_times(diff):
    """A job diff with its submit-time fields dropped (wall clocks)."""
    if isinstance(diff, dict):
        return {k: _strip_times(v) for k, v in diff.items()}
    if isinstance(diff, list):
        return [_strip_times(v) for v in diff
                if not (isinstance(v, dict) and v.get("Name") == "SubmitTime")]
    return diff


def test_plan_job_equals_the_jax_server():
    """Server.plan_job on a CPU server, with and without its diff: the
    annotations, failed task groups, index and diff equal the JAX
    server's, and the dry run never touches CUDA."""
    import nomad_tpu.mock as jmock
    import torch
    from nomad_tpu.server import Server as JaxServer
    from nomad_tpu.server import ServerConfig as JaxServerConfig

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server, ServerConfig

    kw = dict(num_schedulers=1, deterministic=True, pipeline_async=False)
    port = _plans(Server, ServerConfig(device="cpu", **kw), mock, parse_job)
    ref = _plans(JaxServer, JaxServerConfig(**kw), jmock, jjobspec.parse_job)
    assert not torch.cuda.is_initialized()
    assert _strip_times(port) == _strip_times(ref)
    ann, failed, _index, diff = port["new"]
    assert ann["desired_tg_updates"]["web"]["place"] == 6 and failed is None and diff is None
    assert port["new_diff"][3]["Type"] == "Added"
    scale_ann, _, _, scale_diff = port["scale"]
    assert scale_ann["desired_tg_updates"]["web"]["place"] == 3
    assert scale_diff["Type"] == "Edited"
    count = [f for tg in scale_diff["TaskGroups"] for f in tg["Fields"] if f["Name"] == "Count"]
    assert count and (count[0]["Old"], count[0]["New"]) == ("6", "9")
    assert port["stop"][3]["Type"] == "Deleted"
    assert port["stop"][0]["desired_tg_updates"]["web"]["stop"] == 6


def test_plan_job_runs_on_the_servers_device(monkeypatch):
    """The dry run's Harness and scheduler take ServerConfig.device: a
    CPU server asks nothing of CUDA (it raised "device 'cuda' requested"
    before), and the scheduler it builds runs on the CPU."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import testing
    from nomad_tpu_torch.server import Server, ServerConfig

    devices = []
    orig_process = testing.Harness.__init__

    def spy(self, state=None, device="cuda"):
        devices.append(device)
        orig_process(self, state, device)

    monkeypatch.setattr(testing.Harness, "__init__", spy)
    srv = Server(ServerConfig(device="cpu", num_schedulers=0))
    try:
        srv.start()
        srv.register_node(mock.node())
        ann, failed, _, _ = srv.plan_job(parse_job(PLAN_JOB))
        assert devices == ["cpu"]
        assert ann.desired_tg_updates["web"].place == 6 and failed is None
    finally:
        srv.stop()
