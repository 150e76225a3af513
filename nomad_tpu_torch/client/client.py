"""Client agent: node lifecycle + allocation execution.

Fills the role of reference ``client/client.go`` (2,900 LoC): register
(client.go:1670), heartbeat (:1433/:1700), watch allocations via blocking
query (:1873 watchAllocations), diff + spawn/update/remove alloc runners
(:2092 runAllocs), batched alloc status sync every 200ms (:1807 allocSync),
and state restore on boot (:991). The server is reached through a
``ServerProxy`` interface — in-process today, the RPC transport binds the
same surface at the process boundary.

Copied from ``nomad_tpu/client/client.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Changes: the logger is
``nomad_tpu_torch.client.<id>``; ``device_plugins`` takes ``{"cuda": {}}``
(the port's built-in cuda plugin) where the reference takes ``{"tpu":
{}}``.
"""
from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..structs.structs import (
    ALLOC_DESIRED_RUN,
    Allocation,
    Node,
)
from .allocrunner import AllocRunner
from .fingerprint import fingerprint_node
from .state import MemDB, SqliteDB, StateDB

ALLOC_SYNC_INTERVAL = 0.2  # client.go:90 allocSyncIntv


@dataclass
class ClientConfig:
    state_dir: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    persist_state: bool = False
    heartbeat_grace: float = 0.5
    token: str = ""  # ACL token for server + cross-node fs calls
    tls: Optional[object] = None  # TLSConfig for https node addresses
    # Consul agent address for task service registration (command/agent/
    # consul ServiceClient); empty = disabled
    consul: Optional[object] = None  # integrations.consul.ConsulConfig
    # Vault address for the template hook's {{ secret }} reads (the token
    # is the TASK's derived token, never the server's)
    vault_addr: str = ""
    # host_volume stanzas (reference client config): name -> host path,
    # advertised on the node for the HostVolumeChecker
    host_volumes: Dict[str, str] = field(default_factory=dict)
    # external plugins (reference client config plugin_dir + plugin stanzas):
    # plugin_dir is scanned for nomad-driver-*/nomad-device-* executables;
    # external_drivers forces built-in drivers out-of-process (the
    # reference's go-plugin default), name → plugin config stanza
    plugin_dir: str = ""
    external_drivers: Dict[str, dict] = field(default_factory=dict)
    # built-in device plugins to run, name → config stanza (e.g.
    # {"cuda": {}} or {"mock-device": {"count": 4}}); external device
    # plugins arrive via plugin_dir discovery
    device_plugins: Dict[str, dict] = field(default_factory=dict)
    # Terminal-alloc-dir GC (reference client/gc.go AllocGarbageCollector
    # + config.go GCInterval/GCDiskUsageThreshold/GCMaxAllocs): a
    # background sweep destroys the OLDEST terminal alloc runners (and
    # their dirs) when the alloc-dir filesystem passes the usage
    # threshold or the retained-alloc count passes gc_max_allocs.
    gc_interval: float = 60.0
    gc_disk_usage_threshold: float = 80.0  # percent of the alloc-dir fs
    gc_max_allocs: int = 50


class ServerProxy:
    """The client⇆server RPC surface (the endpoints client.go dials)."""

    def __init__(self, server) -> None:
        self.server = server

    def register_node(self, node: Node) -> float:
        return self.server.register_node(node)

    def heartbeat(self, node_id: str) -> float:
        return self.server.heartbeat(node_id)

    def pull_allocs(self, node_id: str, min_index: int, timeout: float):
        """Node.GetClientAllocs blocking query: (allocs, index)."""
        state = self.server.fsm.state

        def run(s):
            return [self._with_job(s, a) for a in s.allocs_by_node(node_id)]

        return state.blocking_query(run, min_index, timeout=timeout)

    @staticmethod
    def _with_job(state, alloc: Allocation) -> Allocation:
        if alloc.job is None:
            a = alloc.copy_skip_job()
            a.job = state.job_by_id(alloc.namespace, alloc.job_id)
            return a
        return alloc

    def update_allocs(self, allocs: List[Allocation]) -> None:
        self.server.update_allocs_from_client(allocs)

    def alloc_info(self, alloc_id: str) -> Optional[dict]:
        """Status + owning-node HTTP address of any alloc (the allocwatcher's
        view of Alloc.GetAlloc + Node.GetNode)."""
        state = self.server.fsm.state
        alloc = state.alloc_by_id(alloc_id)
        if alloc is None:
            return None
        node = state.node_by_id(alloc.node_id)
        return {
            "client_status": alloc.client_status,
            "node_http_addr": node.http_addr if node is not None else "",
        }

    def derive_vault_token(
        self, alloc_id: str, task_name: str, node_id: str = "", node_secret: str = ""
    ) -> str:
        """Node.DeriveVaultToken (node_endpoint.go)."""
        return self.server.derive_vault_token(
            alloc_id, [task_name], node_id, node_secret
        )[task_name]


class Client:
    def __init__(
        self,
        proxy: ServerProxy,
        config: Optional[ClientConfig] = None,
        node: Optional[Node] = None,
    ) -> None:
        self.config = config or ClientConfig()
        self.proxy = proxy
        if not self.config.state_dir:
            self.config.state_dir = tempfile.mkdtemp(prefix="nomad-client-")
        self.alloc_dir_base = os.path.join(self.config.state_dir, "allocs")

        # external plugins register into the driver registry BEFORE
        # fingerprinting so discovered drivers land in node attributes
        # (reference: plugin managers run before fingerprint merge)
        self.plugin_catalog = None
        if self.config.plugin_dir:
            from ..plugins.catalog import Catalog

            self.plugin_catalog = Catalog(self.config.plugin_dir).discover()
        # subprocess drivers this client owns (NOT process-global: two
        # clients in one process must not share or kill each other's
        # plugin subprocesses)
        self._external_driver_instances: Dict[str, object] = {}
        self._external_lock = threading.Lock()

        # device plugins: built-ins by name plus any discovered externally
        self.device_manager = None
        device_plugins = []
        for dev_name, dev_config in self.config.device_plugins.items():
            from .devicemanager import builtin_device_plugin

            device_plugins.append(builtin_device_plugin(dev_name, dev_config))
        if self.plugin_catalog is not None:
            device_plugins.extend(self.plugin_catalog.devices.values())
        if device_plugins:
            from .devicemanager import DeviceManager

            self.device_manager = DeviceManager(device_plugins)

        # Consul service client (command/agent/consul)
        self.consul = None
        if self.config.consul is not None and getattr(self.config.consul, "address", ""):
            from ..integrations.consul import ConsulClient

            self.consul = ConsulClient(self.config.consul)

        self.node = node or Node()
        self.node.datacenter = self.config.datacenter
        self.node.node_class = self.config.node_class
        self.node.meta.update(self.config.meta)
        if self.config.host_volumes:
            from ..structs.structs import HostVolume

            for vname, vpath in self.config.host_volumes.items():
                if not os.path.isdir(vpath):
                    # the reference client refuses to start on a missing
                    # host_volume path — fail loud, not at task runtime
                    raise ValueError(
                        f"host_volume {vname!r}: path {vpath!r} is not a "
                        "directory")
                self.node.host_volumes[vname] = HostVolume(
                    name=vname, path=vpath)
        fingerprint_node(self.node)
        if self.device_manager is not None:
            self.device_manager.fingerprint_node(self.node)
            self.node.compute_class()

        self.logger = logging.getLogger(f"nomad_tpu_torch.client.{self.node.id[:8]}")
        self.state_db: StateDB = (
            SqliteDB(self.config.state_dir) if self.config.persist_state else MemDB()
        )
        self.allocrunners: Dict[str, AllocRunner] = {}
        self._dirty: Dict[str, Allocation] = {}  # pending status syncs
        # locally GC'd alloc id -> modify_index at collection: guards
        # _run_allocs against re-adding from a stale in-flight pull
        self._gced: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self.heartbeat_ttl = 10.0

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._restore_state()
        if self.device_manager is not None:
            # periodic re-fingerprint; device changes re-register the node
            # so the scheduler sees fresh capacity
            def _devices_changed(devices):
                from .devicemanager import DeviceManager as _DM

                _DM.apply_to_node(self.node, devices)
                self.node.compute_class()
                self.proxy.register_node(self.node)

            self.device_manager.on_devices_changed = _devices_changed
            self.device_manager.start()
        try:
            self.heartbeat_ttl = self.proxy.register_node(self.node)
        except Exception as e:  # noqa: BLE001 — no leader yet at boot
            self.logger.warning(
                "node registration failed (retrying in background): %s", e
            )
            t = threading.Thread(
                target=self._register_retry_loop, name="client-register", daemon=True
            )
            t.start()
            self._threads.append(t)
        for target, name in (
            (self._heartbeat_loop, "heartbeat"),
            (self._watch_allocations, "watchallocs"),
            (self._alloc_sync_loop, "allocsync"),
            (self._gc_loop, "gc"),
        ):
            t = threading.Thread(target=target, name=f"client-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def _register_retry_loop(self) -> None:
        """Keep trying to register until a leader exists
        (client.go:1670 retryRegisterNode)."""
        while not self._shutdown.wait(2.0):
            try:
                self.heartbeat_ttl = self.proxy.register_node(self.node)
                self.logger.info("node registered")
                return
            except Exception as e:  # noqa: BLE001
                self.logger.debug("registration retry failed: %s", e)

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._lock:
            runners = list(self.allocrunners.values())
        for ar in runners:
            ar.stop()
        self.state_db.close()
        if self.device_manager is not None:
            self.device_manager.stop()
        if self.plugin_catalog is not None:
            self.plugin_catalog.close()
        close_proxy = getattr(self.proxy, "close", None)
        if close_proxy is not None:
            close_proxy()
        # stop the subprocess drivers this client owns
        with self._external_lock:
            instances = list(self._external_driver_instances.values())
            self._external_driver_instances.clear()
        for inst in instances:
            try:
                inst.close()
            except Exception:  # noqa: BLE001
                pass

    def resolve_driver(self, name: str):
        """Driver factory for this client's task runners: external_drivers
        names get a client-owned subprocess plugin instance (respawned if
        dead); everything else resolves through the shared registry."""
        if name not in self.config.external_drivers:
            from .drivers.base import new_driver

            return new_driver(name)
        from ..plugins.base import validate_config
        from ..plugins.catalog import launch_builtin_driver
        from .drivers.base import DriverError

        with self._external_lock:
            inst = self._external_driver_instances.get(name)
            if inst is not None and inst.client.alive():
                return inst
            inst = launch_builtin_driver(name)
            drv_config = self.config.external_drivers.get(name)
            if drv_config:
                schema = inst.config_schema()
                errors = validate_config(schema, drv_config) if schema else []
                if errors:
                    inst.close()
                    raise DriverError("; ".join(errors))
                inst.set_config(drv_config)
            self._external_driver_instances[name] = inst
            return inst

    # -- restore (client.go:991) -----------------------------------------

    def _restore_state(self) -> None:
        for alloc in self.state_db.get_all_allocations():
            if alloc.terminal_status():
                continue
            # a restart mid-wait must resume the await+migrate, not skip it
            watcher = self._make_prev_watcher(alloc)
            ar = AllocRunner(
                alloc, self.alloc_dir_base, node=self.node, on_update=self._on_ar_update,
                device_manager=self.device_manager, driver_factory=self.resolve_driver,
                consul=self.consul, vault_fn=self._vault_fn(),
                vault_addr=self.config.vault_addr,
                prev_alloc_watcher=watcher,
            )
            # re-attach live tasks BEFORE the runners start, so a recovered
            # task is waited on instead of started a second time
            handles = self.state_db.get_task_handles(alloc.id)
            self.allocrunners[alloc.id] = ar
            if watcher is not None:
                # never block startup on a prev-alloc wait: registration
                # and heartbeats must begin or the server marks us down
                threading.Thread(
                    target=ar.run, kwargs={"recover_handles": handles},
                    name=f"allocrestore-{alloc.id[:8]}", daemon=True,
                ).start()
            else:
                ar.run(recover_handles=handles)

    # -- heartbeats (client.go:1700) -------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set():
            interval = max(self.heartbeat_ttl / 2.0, 0.05)
            if self._shutdown.wait(timeout=interval):
                return
            try:
                self.heartbeat_ttl = self.proxy.heartbeat(self.node.id)
            except Exception:  # noqa: BLE001
                self.logger.warning("heartbeat failed; retrying")

    # -- alloc watching (client.go:1873) ---------------------------------

    # rewound pulls must persist this long before the client adopts the
    # servers' older view as the new truth (DR restore / rebuilt
    # cluster). Transient replication lag after a failover clears in
    # seconds; adopting too eagerly could resurrect an alloc this
    # client GC'd (a lagging follower still lists it desired-run and
    # the _gced guard was pruned when a newer view omitted it).
    REWIND_ADOPT_AFTER_S = 30.0

    def _watch_allocations(self) -> None:
        import time as _time

        index = 0
        rewind_t0: Optional[float] = None
        while not self._shutdown.is_set():
            try:
                allocs, new_index = self.proxy.pull_allocs(
                    self.node.id, index, timeout=1.0
                )
            except Exception:  # noqa: BLE001
                if self._shutdown.wait(timeout=1.0):
                    return
                continue
            # Act only on strictly NEWER views. A blocking-query timeout
            # returns index == min_index (nothing changed), and after a
            # server failover a lagging follower can return an OLDER
            # view than we already processed — acting on a rewound view
            # could resurrect an alloc this client GC'd (its _gced guard
            # entry is pruned once a newer view omits the id).
            if new_index < index:
                # ...unless the rewind is PERMANENT (servers restored
                # from an older snapshot / rebuilt cluster): only after
                # rewound replies persist for REWIND_ADOPT_AFTER_S do we
                # adopt the servers' view instead of wedging alloc sync
                # forever. A follower merely catching up converges and
                # returns a newer index well before the deadline, which
                # resets the streak below.
                now = _time.monotonic()
                if rewind_t0 is None:
                    rewind_t0 = now
                if now - rewind_t0 < self.REWIND_ADOPT_AFTER_S:
                    continue
                self.logger.warning(
                    "server alloc index rewound %d -> %d for over %.0fs; "
                    "adopting server view", index, new_index,
                    self.REWIND_ADOPT_AFTER_S,
                )
            elif new_index == index:
                continue
            rewind_t0 = None
            index = new_index
            self._run_allocs(allocs)

    def _run_allocs(self, server_allocs: List[Allocation]) -> None:
        """Diff server view vs runners (client.go:2092 runAllocs)."""
        with self._lock:
            existing = dict(self.allocrunners)
        server_ids = {a.id for a in server_allocs}

        for alloc in server_allocs:
            ar = existing.get(alloc.id)
            if ar is None:
                if alloc.desired_status != ALLOC_DESIRED_RUN or alloc.terminal_status():
                    continue
                gc_index = self._gced.get(alloc.id)
                if gc_index is not None and alloc.modify_index <= gc_index:
                    continue  # stale pull of a locally GC'd alloc
                self._add_alloc(alloc)
            elif alloc.modify_index > ar.alloc.modify_index:
                ar.update(alloc)
                self.state_db.put_allocation(alloc)

        # server no longer knows these allocs (GC'd): destroy
        for alloc_id, ar in existing.items():
            if alloc_id not in server_ids:
                ar.destroy()
                self.state_db.delete_allocation(alloc_id)
                with self._lock:
                    self.allocrunners.pop(alloc_id, None)

        # Prune the GC guard once the server stops reporting an alloc:
        # pulls arrive from ONE sequential loop, so an id absent from
        # this (newest) pull can never resurface in a later one — the
        # guard entry is dead weight on a long-lived node otherwise.
        with self._lock:
            for aid in [a for a in self._gced if a not in server_ids]:
                del self._gced[aid]

    def _vault_fn(self):
        fn = getattr(self.proxy, "derive_vault_token", None)
        if fn is None:
            return None
        # bind this node's identity: the server verifies (node_id, secret)
        # against the registered node before minting tokens
        node = self.node

        def derive(alloc_id: str, task_name: str) -> str:
            return fn(alloc_id, task_name, node.id, node.secret_id)

        return derive

    def _make_prev_watcher(self, alloc: Allocation):
        """Upstream-alloc hook: replacements await their predecessor and
        migrate sticky ephemeral disk (client/allocwatcher)."""
        if not alloc.previous_allocation:
            return None
        from .allocwatcher import PrevAllocWatcher

        return PrevAllocWatcher(
            alloc,
            alloc.previous_allocation,
            local_runner_lookup=lambda aid: self.allocrunners.get(aid),
            alloc_dir_base=self.alloc_dir_base,
            remote_alloc_info=getattr(self.proxy, "alloc_info", None),
            auth_token=self.config.token,
            tls=self.config.tls,
        ).wait_and_migrate

    def _add_alloc(self, alloc: Allocation) -> None:
        watcher = self._make_prev_watcher(alloc)
        ar = AllocRunner(
            alloc, self.alloc_dir_base, node=self.node, on_update=self._on_ar_update,
            device_manager=self.device_manager, driver_factory=self.resolve_driver,
            consul=self.consul, vault_fn=self._vault_fn(),
            vault_addr=self.config.vault_addr,
            prev_alloc_watcher=watcher,
        )
        with self._lock:
            self.allocrunners[alloc.id] = ar
        self.state_db.put_allocation(alloc)

        def run_runner() -> None:
            ar.run()
            for name, tr in ar.task_runners.items():
                if tr.handle is not None:
                    self.state_db.put_task_handle(alloc.id, name, tr.handle)
            self._on_ar_update(ar)

        if watcher is not None:
            # the prev-alloc wait can block for minutes; it must not stall
            # the watchallocations loop (alloc_runner.go Run is a goroutine)
            t = threading.Thread(
                target=run_runner, name=f"allocrun-{alloc.id[:8]}", daemon=True
            )
            t.start()
        else:
            run_runner()

    # -- status sync (client.go:1807 allocSync) --------------------------

    def _on_ar_update(self, ar: AllocRunner) -> None:
        with self._lock:
            self._dirty[ar.alloc.id] = ar.client_alloc()
        for name, tr in ar.task_runners.items():
            if tr.handle is not None:
                self.state_db.put_task_handle(ar.alloc.id, name, tr.handle)

    def _alloc_sync_loop(self) -> None:
        while not self._shutdown.wait(timeout=ALLOC_SYNC_INTERVAL):
            with self._lock:
                if not self._dirty:
                    continue
                batch = list(self._dirty.values())
                self._dirty.clear()
            try:
                self.proxy.update_allocs(batch)
            except Exception:  # noqa: BLE001
                with self._lock:  # retry next tick
                    for a in batch:
                        self._dirty.setdefault(a.id, a)

    # -- terminal-alloc GC (reference client/gc.go) ----------------------

    def _gc_loop(self) -> None:
        """Periodic sweep (gc.go run): destroy the oldest terminal alloc
        runners when the alloc-dir filesystem passes the usage threshold
        or the retained count passes gc_max_allocs. A long-lived node
        must not keep dead alloc dirs forever."""
        while not self._shutdown.wait(timeout=self.config.gc_interval):
            try:
                self.garbage_collect(force=False)
            except Exception:  # noqa: BLE001 — GC must never kill the loop
                self.logger.exception("alloc GC sweep failed")

    def _disk_usage_pct(self) -> float:
        import shutil as _shutil

        try:
            du = _shutil.disk_usage(self.alloc_dir_base)
            return 100.0 * du.used / max(du.total, 1)
        except OSError:
            return 0.0

    def garbage_collect(self, force: bool = True) -> int:
        """GC terminal alloc runners; ``force`` (the /v1/client/gc shape,
        gc.go CollectAll) destroys every terminal runner, otherwise only
        down to the configured thresholds, oldest-completion first.
        Returns the number of allocs collected.

        The terminal client status is pushed to the server FIRST: a
        runner destroyed while its completion still sits in the dirty
        batch would be re-added by the next pull (the server still shows
        it running) and the task would execute twice. Sync failure skips
        collection this round."""
        with self._lock:
            terminal = [
                ar for ar in self.allocrunners.values()
                if ar.client_alloc().client_terminal_status()
            ]
        if not terminal:
            return 0
        try:
            self.proxy.update_allocs([ar.client_alloc() for ar in terminal])
            with self._lock:
                for ar in terminal:
                    self._dirty.pop(ar.alloc.id, None)
        except Exception:  # noqa: BLE001 — no server: do not destroy state
            self.logger.warning("alloc GC skipped: terminal status sync failed")
            return 0
        # oldest completion first (gc.go's indexed PQ ordering)
        terminal.sort(key=lambda ar: ar.alloc.modify_time_ns or ar.alloc.create_time_ns)
        collected = 0
        for ar in terminal:
            if not force:
                over_disk = (
                    self._disk_usage_pct() >= self.config.gc_disk_usage_threshold
                )
                over_count = self.num_allocs() > self.config.gc_max_allocs
                if not over_disk and not over_count:
                    break
            self.logger.info("garbage collecting alloc %s", ar.alloc.id[:8])
            try:
                ar.destroy()
            except Exception:  # noqa: BLE001
                self.logger.exception("alloc %s destroy failed", ar.alloc.id[:8])
            self.state_db.delete_allocation(ar.alloc.id)
            with self._lock:
                self.allocrunners.pop(ar.alloc.id, None)
                # an in-flight stale pull must not resurrect it
                self._gced[ar.alloc.id] = ar.alloc.modify_index
            collected += 1
        return collected

    # -- introspection ---------------------------------------------------

    def num_allocs(self) -> int:
        with self._lock:
            return len(self.allocrunners)
