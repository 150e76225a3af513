"""The port's device path: the device plugins (``nomad_tpu_torch/plugins``),
the device manager (``client/devicemanager``) and GPU jobs placed through
the engine's device dimensions, held against the JAX package.

This file imports nothing of the JAX package at module level: the card
test of ``tests/test_torch_cuda.py`` reuses its fleet helper on the GPU
host, which has no JAX.

1. The five ``TestDeviceManager`` cases of ``tests/test_devicemanager.py``
   and the three ``TestDevicePlugin`` cases of ``tests/test_plugins.py``
   (over the subprocess transport, with the port's ``launch`` and
   ``mock_device``), ``TestConfigSchema`` and the four ``TestHclSpec``
   cases, on the port; the plugin payload types through the wire codec.
2. The ``cuda`` plugin with ``torch.cuda`` stood in for: no group without
   CUDA (nothing falls back to the CPU); with it, one group per device
   name, ``CUDA_VISIBLE_DEVICES`` and an error for an unknown ordinal.
3. A 50-node GPU fleet (``chip_smoke.gpu_fleet``: node 0 fingerprinted by
   the ``cuda`` plugin, the others by mock GPU plugins, every fourth
   with an FPGA group) through the port's server and the JAX server, int
   arm: every job's allocs on the same nodes with the same device
   instance IDs, D = 5 and D = 6, a system GPU job included.
"""
import sys
import time

import pytest
import torch

import chip_smoke
from nomad_tpu_torch import mock
from nomad_tpu_torch.client.devicemanager import (
    DeviceManager,
    DeviceReservationError,
    builtin_device_plugin,
)
from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DEVICE, validate_config
from nomad_tpu_torch.plugins.cuda_device import CUDADevicePlugin
from nomad_tpu_torch.plugins.launch import plugin_env
from nomad_tpu_torch.plugins.mock_device import MockDevicePlugin
from nomad_tpu_torch.plugins.transport import PluginError, spawn_plugin
from nomad_tpu_torch.structs.structs import AllocatedDeviceResource

GPU_NAME = "NVIDIA H100 80GB HBM3"


def fake_cuda(monkeypatch, names):
    """``torch.cuda`` as a host with these cards would report them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: bool(names))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(names))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: names[i])


# -- 1. tests/test_devicemanager.py's TestDeviceManager on the port ----------


class TestDeviceManager:
    def test_fingerprint_merges_into_node(self):
        dm = DeviceManager([MockDevicePlugin(count=3)])
        node = mock.node()
        node.node_resources.devices = []
        dm.fingerprint_node(node)
        devs = node.node_resources.devices
        assert len(devs) == 1
        assert (devs[0].vendor, devs[0].type, devs[0].name) == ("nomad", "gpu", "mock")
        assert len(devs[0].instances) == 3
        assert node.attributes["device.nomad.gpu.mock.count"] == "3"
        assert node.attributes["device.nomad.gpu.mock.memory_mib"] == "4096"

    def test_reserve_routes_to_owning_plugin(self):
        dm = DeviceManager([MockDevicePlugin(count=2)])
        dm.fingerprint()
        res = dm.reserve([
            AllocatedDeviceResource(vendor="nomad", type="gpu", name="mock",
                                    device_ids=["mock-0", "mock-1"])
        ])
        assert res.envs == {"MOCK_VISIBLE_DEVICES": "mock-0,mock-1"}

    def test_reserve_unknown_group_raises(self):
        dm = DeviceManager([MockDevicePlugin()])
        dm.fingerprint()
        with pytest.raises(DeviceReservationError):
            dm.reserve([AllocatedDeviceResource(vendor="x", type="y", name="z",
                                                device_ids=["a"])])

    def test_sick_plugin_does_not_kill_fingerprint(self):
        class Sick(MockDevicePlugin):
            def fingerprint(self):
                raise RuntimeError("nvml exploded")

        dm = DeviceManager([Sick(), MockDevicePlugin(model="ok")])
        groups = dm.fingerprint()
        assert [g.name for g in groups] == ["ok"]

    def test_builtin_factory(self):
        p = builtin_device_plugin("mock-device", {"count": 5})
        assert len(p.fingerprint()[0].devices) == 5
        with pytest.raises(ValueError):
            builtin_device_plugin("nope")


def test_device_manager_equals_the_jax_manager():
    """The same plugins' fingerprints merged into the same node, and the
    same reservation, through both packages' device managers."""
    from nomad_tpu import mock as jmock
    from nomad_tpu.client.devicemanager import DeviceManager as JaxDeviceManager
    from nomad_tpu.plugins.mock_device import MockDevicePlugin as JaxMock
    from nomad_tpu.structs.structs import AllocatedDeviceResource as JaxAllocated
    from test_torch_jobspec import plain

    def run(dm_cls, mock_cls, node, allocated_cls):
        dm = dm_cls([mock_cls(count=3), mock_cls(vendor="acme", model="m2", count=1)])
        node.node_resources.devices = []
        dm.fingerprint_node(node)
        res = dm.reserve([allocated_cls(vendor="nomad", type="gpu", name="mock",
                                        device_ids=["mock-2", "mock-0"])])
        return (plain(node.node_resources.devices),
                {k: v for k, v in node.attributes.items() if k.startswith("device.")},
                plain(res))

    assert run(DeviceManager, MockDevicePlugin, mock.node(), AllocatedDeviceResource) == \
        run(JaxDeviceManager, JaxMock, jmock.node(), JaxAllocated)


def test_mock_device_type_option():
    """The port's one addition to the mock plugin: the group's type."""
    p = MockDevicePlugin(vendor="xilinx", model="alveo", count=2, device_type="fpga")
    g = p.fingerprint()[0]
    assert (g.vendor, g.type, g.name) == ("xilinx", "fpga", "alveo")
    p.set_config({"type": "asic", "count": 1})
    assert p.fingerprint()[0].type == "asic" and len(p.fingerprint()[0].devices) == 1
    assert MockDevicePlugin().fingerprint()[0].type == "gpu"


# -- tests/test_plugins.py's TestDevicePlugin, TestConfigSchema, TestHclSpec --


class TestDevicePlugin:
    @pytest.fixture
    def ext_device(self):
        from nomad_tpu_torch.plugins.device import ExternalDevicePlugin

        client = spawn_plugin(
            [sys.executable, "-m", "nomad_tpu_torch.plugins.launch",
             "device", "nomad_tpu_torch.plugins.mock_device:plugin"],
            env=plugin_env(),
        )
        dev = ExternalDevicePlugin("mock-device", client)
        yield dev
        dev.close()

    def test_fingerprint_reserve_stats(self, ext_device):
        from nomad_tpu_torch.plugins.device import DeviceGroup, DeviceStats

        info = ext_device.client.call("plugin_info", timeout=5.0)
        assert info.type == PLUGIN_TYPE_DEVICE
        groups = ext_device.fingerprint()
        assert len(groups) == 1
        g = groups[0]
        assert isinstance(g, DeviceGroup)
        assert (g.vendor, g.type, g.name) == ("nomad", "gpu", "mock")
        assert [d.id for d in g.devices] == ["mock-0", "mock-1"]
        res = ext_device.reserve(["mock-1"])
        assert res.envs == {"MOCK_VISIBLE_DEVICES": "mock-1"}
        stats = ext_device.stats()
        assert isinstance(stats, DeviceStats)
        assert set(stats.instance_stats) == {"mock-0", "mock-1"}

    def test_reserve_unknown_device_errors(self, ext_device):
        with pytest.raises(PluginError, match="unknown device"):
            ext_device.reserve(["nope-9"])

    def test_set_config_changes_fingerprint(self, ext_device):
        ext_device.client.call("set_config", {"model": "tpu", "count": 4}, timeout=5.0)
        groups = ext_device.fingerprint()
        assert len(groups[0].devices) == 4
        assert groups[0].name == "tpu"


def test_device_manager_over_the_subprocess_transport():
    """A DeviceManager whose plugins are a subprocess (the mock GPU, by
    the port's launch shim) and an in-process FPGA mock: the fingerprint
    merges both, every method of the protocol crosses the socket with its
    types, and a reservation routes to the subprocess."""
    from nomad_tpu_torch.plugins.device import ContainerReservation, ExternalDevicePlugin

    client = spawn_plugin(
        [sys.executable, "-m", "nomad_tpu_torch.plugins.launch", "device",
         "nomad_tpu_torch.plugins.mock_device:plugin"], env=plugin_env())
    ext = ExternalDevicePlugin("mock-device", client)
    dm = DeviceManager([ext, MockDevicePlugin(vendor="xilinx", model="alveo", count=2,
                                              device_type="fpga")])
    try:
        schema = client.call("config_schema", timeout=5.0)
        assert schema == MockDevicePlugin.config_schema_spec
        client.call("set_config", {"vendor": "nvidia", "model": GPU_NAME, "count": 3},
                    timeout=5.0)
        node = mock.node()
        dm.fingerprint_node(node)
        got = [(d.vendor, d.type, d.name, [i.id for i in d.instances])
               for d in node.node_resources.devices]
        assert got == [("nvidia", "gpu", GPU_NAME, [f"{GPU_NAME}-{i}" for i in range(3)]),
                       ("xilinx", "fpga", "alveo", ["alveo-0", "alveo-1"])]
        res = dm.reserve([
            AllocatedDeviceResource(vendor="nvidia", type="gpu", name=GPU_NAME,
                                    device_ids=[f"{GPU_NAME}-2", f"{GPU_NAME}-0"])])
        assert isinstance(res, ContainerReservation)
        assert res.envs == {"MOCK_VISIBLE_DEVICES": f"{GPU_NAME}-0,{GPU_NAME}-2"}
        res = dm.reserve([AllocatedDeviceResource(vendor="xilinx", type="fpga", name="alveo",
                                                  device_ids=["alveo-1"])])
        assert res.envs == {"MOCK_VISIBLE_DEVICES": "alveo-1"}
        with pytest.raises(PluginError, match="unknown device"):
            dm.reserve([AllocatedDeviceResource(vendor="nvidia", type="gpu", name=GPU_NAME,
                                                device_ids=[f"{GPU_NAME}-7"])])
    finally:
        dm.stop()
    assert not ext.client.alive()


def test_launch_refuses_the_driver_kind():
    """The launch shim's driver kind: ``launch driver mock`` serves the
    port's mock driver over the transport (a task runs to its exit code
    across the process boundary), and a driver name the port does not
    have is refused, the shim exiting non-zero."""
    import subprocess

    from nomad_tpu_torch.client.drivers.base import TaskConfig
    from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DRIVER
    from nomad_tpu_torch.plugins.driver_plugin import ExternalDriver

    drv = ExternalDriver("mock", spawn_plugin(
        [sys.executable, "-m", "nomad_tpu_torch.plugins.launch", "driver", "mock"],
        env=plugin_env()))
    try:
        info = drv.plugin_info()
        assert (info.type, info.name) == (PLUGIN_TYPE_DRIVER, "mock")
        drv.start_task(TaskConfig(id="l1", name="w", config={"run_for": "50ms",
                                                              "exit_code": 4}))
        assert drv.wait_task("l1", timeout=10.0).exit_code == 4
    finally:
        drv.close()
    out = subprocess.run([sys.executable, "-m", "nomad_tpu_torch.plugins.launch", "driver",
                          "no-such-driver"], capture_output=True, text=True, timeout=120,
                         env=plugin_env())
    assert out.returncode != 0 and "no-such-driver" in out.stderr


def test_plugin_payloads_cross_the_codec():
    """The plugin payload types are registered in the port's codec: each
    comes back as its own type, in the JAX codec's bytes."""
    from nomad_tpu.rpc import codec as jcodec
    from nomad_tpu_torch.plugins.base import PluginInfo
    from nomad_tpu_torch.plugins.device import (
        ContainerReservation,
        DetectedDevice,
        DeviceGroup,
        DeviceSpec,
        DeviceStats,
        Mount,
    )
    from nomad_tpu_torch.rpc import decode, encode

    objs = [PluginInfo(type="device", name="cuda"),
            DeviceGroup(vendor="nvidia", type="gpu", name=GPU_NAME,
                        devices=[DetectedDevice(id="0"), DetectedDevice(id="1", healthy=False)],
                        attributes={"count": "2"}),
            ContainerReservation(envs={"CUDA_VISIBLE_DEVICES": "0"},
                                 mounts=[Mount(task_path="/a", host_path="/b")],
                                 devices=[DeviceSpec(task_path="/dev/x", host_path="/dev/y")]),
            DeviceStats(instance_stats={"0": {"healthy": 1.0}}, timestamp_ns=5)]
    for obj in objs:
        back = decode(encode(obj))
        assert type(back) is type(obj) and back == obj
        assert encode(obj) == jcodec.encode(jcodec.decode(encode(obj)))
        assert type(jcodec.decode(encode(obj))).__name__ == type(obj).__name__


class TestConfigSchema:
    def test_validate_config(self):
        schema = {"endpoint": {"type": "string", "required": True},
                  "gc": {"type": "bool"}}
        assert validate_config(schema, {"endpoint": "unix:///x"}) == []
        errs = validate_config(schema, {"gc": "yes"})
        assert any("required" in e for e in errs)
        assert any("expected bool" in e for e in errs)
        assert any("unknown field" in e
                   for e in validate_config(schema, {"endpoint": "x", "zz": 1}))


class TestHclSpec:
    """Schema-as-data decoding (plugins/hclspec.py — the reference's
    plugins/shared/hclspec protocol slot)."""

    def test_attrs_defaults_and_nested_blocks(self):
        from nomad_tpu_torch.plugins.hclspec import decode

        spec = {"block": {"spec": {
            "image": {"attr": {"type": "string", "required": True}},
            "gc": {"default": {
                "primary": {"block": {"spec": {
                    "enabled": {"attr": {"type": "bool"}},
                    "interval": {"default": {
                        "primary": {"attr": {"type": "number"}},
                        "default": 60,
                    }},
                }}},
                "default": {"enabled": True, "interval": 60},
            }},
            "mounts": {"block_list": {"spec": {
                "source": {"attr": {"type": "string", "required": True}},
                "readonly": {"attr": {"type": "bool"}},
            }}},
            "labels": {"attr": {"type": "map(string)"}},
            "args": {"attr": {"type": "list(string)"}},
        }}}
        decoded, errors = decode(spec, {
            "image": "redis:7",
            "gc": {"enabled": False},
            "mounts": [{"source": "/data", "readonly": True}],
            "labels": {"team": "core"},
            "args": ["-v"],
        })
        assert errors == []
        assert decoded["gc"]["interval"] == 60  # default applied
        assert decoded["gc"]["enabled"] is False
        assert decoded["mounts"][0]["source"] == "/data"

    def test_type_errors_and_unknown_fields(self):
        from nomad_tpu_torch.plugins.hclspec import decode

        spec = {"block": {"spec": {
            "count": {"attr": {"type": "number"}},
            "names": {"attr": {"type": "list(string)"}},
        }}}
        _, errors = decode(spec, {"count": "three", "names": [1], "bogus": 1})
        assert any("expected number" in e for e in errors)
        assert any("expected string" in e for e in errors)
        assert any("unknown field" in e for e in errors)

    def test_block_list_and_literal(self):
        from nomad_tpu_torch.plugins.hclspec import decode

        spec = {"block": {"spec": {
            "version": {"literal": {"value": 2}},
            "ports": {"block_list": {"spec": {
                "label": {"attr": {"type": "string", "required": True}},
            }}},
        }}}
        decoded, errors = decode(spec, {"ports": [{"label": "http"}, {}]})
        assert decoded["version"] == 2
        assert any("required" in e for e in errors)  # second port missing label

    def test_bool_not_admitted_as_number(self):
        from nomad_tpu_torch.plugins.hclspec import decode

        spec = {"block": {"spec": {"n": {"attr": {"type": "number"}}}}}
        _, errors = decode(spec, {"n": True})
        assert errors


# -- 2. the cuda plugin --------------------------------------------------------


def test_cuda_plugin_reports_no_devices_without_cuda(monkeypatch):
    """No CUDA: no device group, so nothing to schedule; the plugin does
    not fall back to the CPU, and reserving any ordinal fails."""
    fake_cuda(monkeypatch, [])
    p = builtin_device_plugin("cuda")
    assert isinstance(p, CUDADevicePlugin)
    assert p.fingerprint() == []
    assert p.stats().instance_stats == {}
    with pytest.raises(ValueError, match="unknown CUDA device"):
        p.reserve(["0"])
    dm = DeviceManager([p])
    node = mock.node()
    dm.fingerprint_node(node)
    assert node.node_resources.devices == []
    assert not any(k.startswith("device.") for k in node.attributes)


def test_cuda_plugin_on_this_host_without_cuda():
    """On a host where torch sees no card the real plugin reports none."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert CUDADevicePlugin().fingerprint() == []


def test_cuda_plugin_fingerprint_and_reserve(monkeypatch):
    fake_cuda(monkeypatch, [GPU_NAME, GPU_NAME, "NVIDIA L4"])
    p = CUDADevicePlugin()
    groups = p.fingerprint()
    assert [(g.vendor, g.type, g.name, [d.id for d in g.devices], g.attributes)
            for g in groups] == [
        ("nvidia", "gpu", GPU_NAME, ["0", "1"], {"count": "2"}),
        ("nvidia", "gpu", "NVIDIA L4", ["2"], {"count": "1"})]
    assert p.reserve(["1", "0"]).envs == {"CUDA_VISIBLE_DEVICES": "0,1"}
    assert p.reserve(["2"]).envs == {"CUDA_VISIBLE_DEVICES": "2"}
    with pytest.raises(ValueError, match="unknown CUDA device"):
        p.reserve(["3"])
    assert set(p.stats().instance_stats) == {"0", "1", "2"}
    assert p.plugin_info().type == PLUGIN_TYPE_DEVICE and p.plugin_info().name == "cuda"
    # through the device manager: the node's devices and attributes, and
    # a reservation routed back to the plugin
    dm = DeviceManager([p])
    node = mock.node()
    dm.fingerprint_node(node)
    assert node.attributes[f"device.nvidia.gpu.{GPU_NAME}.count"] == "2"
    res = dm.reserve([AllocatedDeviceResource(vendor="nvidia", type="gpu", name=GPU_NAME,
                                              device_ids=["1"])])
    assert res.envs == {"CUDA_VISIBLE_DEVICES": "1"}


@pytest.mark.parametrize("visible,want", [
    ("3", {"0": "3"}),
    ("2,0", {"0": "2", "1": "0"}),
    ("GPU-5e2f61b4-aaaa-bbbb-cccc-0123456789ab,GPU-0c1d2e3f-dddd-eeee-ffff-ba9876543210",
     {"0": "GPU-5e2f61b4-aaaa-bbbb-cccc-0123456789ab",
      "1": "GPU-0c1d2e3f-dddd-eeee-ffff-ba9876543210"}),
])
def test_cuda_plugin_reserves_the_entry_of_the_callers_visible_set(monkeypatch, visible, want):
    """Under ``CUDA_VISIBLE_DEVICES`` the plugin's ordinals count within
    that set: a reservation exports the set's entry (an index or a UUID)
    for each ordinal, so a task, which inherits the client's environment
    with the reservation over it, binds the card the server assigned."""
    fake_cuda(monkeypatch, [GPU_NAME] * len(want))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    p = CUDADevicePlugin()
    assert [d.id for g in p.fingerprint() for d in g.devices] == sorted(want)
    for ordinal, entry in want.items():
        assert p.reserve([ordinal]).envs == {"CUDA_VISIBLE_DEVICES": entry}
    assert p.reserve(sorted(want, reverse=True)).envs == {
        "CUDA_VISIBLE_DEVICES": ",".join(want[o] for o in sorted(want))}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert p.reserve(["0"]).envs == {"CUDA_VISIBLE_DEVICES": "0"}


def test_cuda_plugin_fingerprint_makes_no_cuda_context(monkeypatch):
    """Fingerprinting reads the count and the names: it never initializes
    a stream or allocates (no ``torch.cuda.init``/``current_device``)."""
    fake_cuda(monkeypatch, [GPU_NAME])
    touched = []
    for name in ("init", "current_device", "set_device", "synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _n=name, **k: touched.append(_n))
    CUDADevicePlugin().fingerprint()
    assert touched == []


# -- 3. a GPU fleet through the port's server and the JAX server ---------------


FLEET_JOBS = {"gpu1": (2, 40, 1, 0), "gpu2": (1, 10, 2, 0), "mixed": (1, 6, 1, 1)}
N_FLEET = 50


def _fleet(monkeypatch):
    """The 50-node fleet on the port (node 0 by the cuda plugin, one
    card) and the same nodes as the JAX package's structs (through the
    JAX codec)."""
    from nomad_tpu.rpc import codec as jcodec
    from nomad_tpu_torch.rpc import encode

    with monkeypatch.context() as m:
        fake_cuda(m, [GPU_NAME])
        nodes, _managers = chip_smoke.gpu_fleet(mock, N_FLEET, 7, CUDADevicePlugin(), GPU_NAME)
    return nodes, [jcodec.decode(encode(n)) for n in nodes]


def _place(server_cls, cfg, nodes, parse, gpu_name=GPU_NAME):
    """Each of the fleet's jobs registered in turn and fully placed; the
    allocs as {(job, alloc name or, for the system job, node): (node,
    devices)}."""
    srv = server_cls(cfg)
    jobs = [parse(hcl) for _, hcl in chip_smoke.gpu_jobs(gpu_name, FLEET_JOBS)]
    want = {j.id: (len(nodes) if j.type == "system" else j.task_groups[0].count)
            for j in jobs}
    try:
        srv.start()
        for n in nodes:
            srv.register_node(n)

        def live(job_id):
            return [a for a in srv.fsm.state.allocs_by_job("default", job_id, True)
                    if a.desired_status == "run"]

        for job in jobs:
            srv.register_job(job)
            deadline = time.monotonic() + 120
            while len(live(job.id)) < want[job.id]:
                assert time.monotonic() < deadline, f"{job.id}: {len(live(job.id))} placed"
                time.sleep(0.05)
            assert srv.drain_evals(60.0)
        names = {n.id: n.name for n in nodes}
        view = {}
        for job in jobs:
            for a in live(job.id):
                devs = sorted((d.vendor, d.type, d.name, tuple(sorted(d.device_ids)))
                              for t in a.allocated_resources.tasks.values() for d in t.devices)
                # a system job's allocs share one name: key them by node
                key = names[a.node_id] if job.type == "system" else a.name
                view[(job.id, key)] = (names[a.node_id], devs)
        return view
    finally:
        srv.stop()


def test_gpu_fleet_places_as_the_jax_server(monkeypatch):
    """Int arm, one worker, every eval on the device path: the system GPU
    job (K4, D = 5), three service jobs asking one or two GPUs (D = 5)
    and one asking a GPU and an FPGA (D = 6) place the same allocs on the
    same nodes with the same instance IDs in both packages."""
    from nomad_tpu.jobspec import parse_job as jparse
    from nomad_tpu.server import Server as JaxServer
    from nomad_tpu.server import ServerConfig as JaxServerConfig
    from nomad_tpu_torch.jobspec import parse_job
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.utils import metrics

    nodes, jnodes = _fleet(monkeypatch)
    kw = dict(num_schedulers=1, deterministic=True, ring_decorrelate=False,
              pipeline_async=False, device_min_placements=0,
              heartbeat_min_ttl=3600.0, heartbeat_max_ttl=7200.0)
    counted = []
    orig = metrics.incr_counter
    monkeypatch.setattr(metrics, "incr_counter",
                        lambda n, v=1.0: (counted.append(n), orig(n, v)))
    port = _place(Server, ServerConfig(device="cpu", **kw), nodes, parse_job)
    ref = _place(JaxServer, JaxServerConfig(**kw), jnodes, jparse)
    assert port == ref
    # every eval took the engine, none fell back or was unported
    assert counted.count("nomad.tpu_engine.handled") >= 5
    assert "nomad.tpu_engine.fallback" not in counted
    assert not any("unported" in c for c in counted)
    fpga_nodes = {n.name for n in nodes
                  if any(d.type == "fpga" for d in n.node_resources.devices)}
    by_node = {}
    for (job_id, _name), (node, devs) in port.items():
        if job_id.startswith("mixed"):
            assert node in fpga_nodes
        for vendor, dtype, dname, ids in devs:
            by_node.setdefault((node, dtype), []).extend(ids)
    for (node, dtype), ids in by_node.items():
        assert len(ids) == len(set(ids)), f"{node}: {dtype} instance assigned twice"
        held = {n.name: n for n in nodes}[node].node_resources.devices
        assert set(ids) <= {i.id for d in held if d.type == dtype for i in d.instances}
    # node 0's one card (ordinal 0) went to the system job, which is
    # placed first; the services found node 0 full
    assert port[("gpu-system", "gpu-0")] == ("gpu-0", [("nvidia", "gpu", GPU_NAME, ("0",))])
    assert sum(1 for job_id, _ in port if job_id == "gpu-system") == N_FLEET
    assert not any(node == "gpu-0" for (job_id, _), (node, _d) in port.items()
                   if job_id != "gpu-system")
