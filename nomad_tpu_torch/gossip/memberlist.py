"""SWIM gossip membership over UDP.

Fills the role of the reference's vendored hashicorp/memberlist + serf
(nomad/server.go:1250 setupSerf; nomad/serf.go event loop): each member
runs a UDP listener, periodically probes a random peer (ping → ack, with
indirect ping-req relays on timeout), and disseminates membership
transitions (alive / suspect / dead / left) as piggybacked broadcasts on
every protocol message. Tags ride the alive message, so metadata updates
(e.g. a server gaining leadership) propagate the same way joins do, and a
member that hears rumors of its own death refutes them with a higher
incarnation number — the standard SWIM+inc protocol memberlist implements.

Intentional deltas from memberlist: push-pull state sync rides UDP (server
gossip pools are small — a handful of servers per region, never the
thousands of client nodes, which don't gossip in the reference either:
clients poll servers over RPC). Message encryption fills the serf keyring
slot: with ``MemberlistConfig.encrypt_key`` set, every datagram is
AES-GCM sealed and unauthenticated packets are dropped (single static
key; no key rotation protocol).

Copied from ``nomad_tpu/gossip/memberlist.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. Changes: packets are framed with
the port's ``rpc/wirefmt`` (the same msgpack bytes) where the reference
imports ``msgpack``; the logger is ``nomad_tpu_torch.gossip.<name>``.
``cryptography`` is imported only when an ``encrypt`` key is set.
"""
from __future__ import annotations

import logging
import random
import socket
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..rpc import wirefmt

STATUS_ALIVE = "alive"
STATUS_SUSPECT = "suspect"
STATUS_DEAD = "dead"
STATUS_LEFT = "left"

MAX_DATAGRAM = 60000


def resolve_advertise_host(host: str) -> str:
    """An unroutable advertise address (0.0.0.0/::) would have every peer
    dialing itself; best-effort resolve the host's primary address."""
    if host in ("0.0.0.0", "::"):
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"
    return host


@dataclass
class Member:
    name: str
    host: str
    port: int
    tags: Dict[str, str] = field(default_factory=dict)
    incarnation: int = 0
    status: str = STATUS_ALIVE
    status_change: float = field(default_factory=time.monotonic)

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "host": self.host,
            "port": self.port,
            "tags": self.tags,
            "inc": self.incarnation,
            "status": self.status,
        }


@dataclass
class MemberlistConfig:
    name: str = "node"
    bind_host: str = "127.0.0.1"
    bind_port: int = 0  # 0 = ephemeral
    # address gossiped to peers; defaults to the bound address, which is
    # wrong when binding 0.0.0.0 — set it explicitly for multi-host
    advertise_host: str = ""
    probe_interval: float = 0.3
    probe_timeout: float = 0.15
    indirect_checks: int = 2
    suspicion_timeout: float = 1.2  # suspect → dead
    push_pull_interval: float = 2.0
    retransmit_mult: int = 3
    dead_reclaim_time: float = 30.0  # forget dead/left members after this
    # Serf keyring slot (reference agent `encrypt` option, memberlist
    # SecretKey): base64 or raw 16/24/32-byte key. When set, every
    # datagram is AES-GCM sealed; plaintext (or wrong-key) packets are
    # dropped. All members must share the key.
    encrypt_key: bytes = b""


def _normalize_gossip_key(key, logger) -> bytes:
    """16/24/32 raw bytes, or their base64 (serf keygen's textual form).
    Base64 takes PRECEDENCE: base64 of a 16-byte key is exactly 24 chars,
    so "len in (16,24,32) -> raw" would silently use the ASCII text as
    the key and split the cluster against nodes configured with the
    decoded bytes."""
    import base64 as b64_mod

    if isinstance(key, str):
        key = key.encode()
    decoded = None
    try:
        decoded = b64_mod.b64decode(key, validate=True)
    except Exception:  # noqa: BLE001 — not base64: try raw
        decoded = None
    if decoded is not None and len(decoded) in (16, 24, 32):
        if len(key) in (16, 24, 32):
            # ambiguous: a 32-char ASCII string is both a valid raw key
            # and valid base64 of 24 bytes — be loud about which reading
            # wins so mixed fleets can't silently partition
            logger.warning(
                "encrypt key is both raw-sized and base64-decodable; "
                "using the BASE64 interpretation (%d bytes)", len(decoded),
            )
        return bytes(decoded)
    if len(key) not in (16, 24, 32):
        raise ValueError(
            "encrypt key must be 16/24/32 bytes raw, or their base64"
        )
    return bytes(key)


class Memberlist:
    """One gossip participant. Thread-safe; all callbacks fire off the
    listener/probe threads — keep them fast and non-blocking."""

    def __init__(self, config: MemberlistConfig, tags: Optional[Dict[str, str]] = None):
        self.config = config
        self.logger = logging.getLogger(f"nomad_tpu_torch.gossip.{config.name}")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((config.bind_host, config.bind_port))
        bound: Tuple[str, int] = self._sock.getsockname()
        advertise_host = resolve_advertise_host(config.advertise_host or bound[0])
        self.addr: Tuple[str, int] = (advertise_host, bound[1])

        # Keyring (serf keyring semantics): index 0 is the PRIMARY key
        # (seals outgoing datagrams); every installed key is tried for
        # unsealing, so a rolling `install -> use -> remove` rotation
        # never partitions the cluster. Empty = plaintext gossip.
        self._keys: List[bytes] = []
        self._aeads: List = []
        # broadcast op ids (dedupe): bounded FIFO — evicting oldest-first
        # keeps recently-seen rumors deduped, where a wholesale clear
        # would let a still-circulating old 'use' op re-apply and flip
        # the primary sealing key back after a rotation completed
        self._keyring_seen: "OrderedDict[str, None]" = OrderedDict()
        # lamport clock over keyring ops: ORDER-SENSITIVE rumors ('use',
        # 'remove') older than the newest applied op are dropped even
        # after their id ages out of the FIFO. 'install' is exempt from
        # the global clock (it is idempotent and commutative, and a
        # delayed install rumor must still apply after unrelated newer
        # ops — dropping it would silently partition the node once the
        # old key is removed); installs are guarded per KEY instead, so
        # an install can never resurrect a key a newer remove deleted.
        self._keyring_clock = 0
        self._key_clocks: Dict[bytes, int] = {}
        if config.encrypt_key:
            key = _normalize_gossip_key(config.encrypt_key, self.logger)
            self._install_key_locked(key)

        self._lock = threading.RLock()
        self.incarnation = 1
        self._local = Member(
            name=config.name,
            host=self.addr[0],
            port=self.addr[1],
            tags=dict(tags or {}),
            incarnation=self.incarnation,
        )
        self.members: Dict[str, Member] = {config.name: self._local}
        # broadcast queue: (remaining_transmits, wire_msg)
        self._broadcasts: List[List] = []
        self._seq = 0
        self._acks: Dict[int, threading.Event] = {}
        self._probe_ring: List[str] = []
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []

        # event hooks (serf EventMemberJoin/Leave/Failed/Update equivalents)
        self.on_join: Optional[Callable[[Member], None]] = None
        self.on_leave: Optional[Callable[[Member], None]] = None
        self.on_fail: Optional[Callable[[Member], None]] = None
        self.on_update: Optional[Callable[[Member], None]] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Memberlist":
        for target, name in (
            (self._listen_loop, "gossip-listen"),
            (self._probe_loop, "gossip-probe"),
            (self._push_pull_loop, "gossip-pushpull"),
        ):
            t = threading.Thread(target=target, name=f"{name}-{self.config.name}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def leave(self) -> None:
        """Graceful exit: broadcast the left intent, then stop."""
        with self._lock:
            self.incarnation += 1
            self._local.incarnation = self.incarnation
            self._local.status = STATUS_LEFT
            msg = {"t": "leave", "name": self.config.name, "inc": self.incarnation}
            self._queue_broadcast(msg)
        # push the rumor out directly to a few peers; the queue alone may
        # never flush since we stop probing immediately after
        for m in self._gossip_targets(3):
            self._send(m.addr, self._with_gossip({"t": "compound"}))
        self.shutdown()

    # -- public API ------------------------------------------------------

    def join(self, seeds: List[Tuple[str, int]]) -> int:
        """Push-pull sync with each seed; returns how many responded."""
        ok = 0
        for addr in seeds:
            if tuple(addr) == self.addr:
                continue
            if self._push_pull(tuple(addr)):
                ok += 1
        return ok

    def force_leave(self, name: str) -> bool:
        """Operator eviction of a (typically failed) member: inject a
        leave rumor at its current incarnation and gossip it (serf
        RemoveFailedNode). A LIVE target will refute with a higher
        incarnation — exactly serf's semantics. Returns False for an
        unknown member."""
        with self._lock:
            cur = self.members.get(name)
            if cur is None or name == self.config.name:
                return False
            inc = cur.incarnation
        self._on_dead_msg(name, inc, STATUS_LEFT)
        return True

    def set_tags(self, tags: Dict[str, str]) -> None:
        """Re-tag and re-broadcast ourselves (serf SetTags)."""
        with self._lock:
            self.incarnation += 1
            self._local.incarnation = self.incarnation
            self._local.tags = dict(tags)
            self._queue_broadcast({"t": "alive", "member": self._local.to_wire()})

    def alive_members(self) -> List[Member]:
        with self._lock:
            return [m for m in self.members.values() if m.status == STATUS_ALIVE]

    def all_members(self) -> List[Member]:
        with self._lock:
            return list(self.members.values())

    def local_member(self) -> Member:
        with self._lock:
            return self._local

    def num_alive(self) -> int:
        return len(self.alive_members())

    # -- keyring (serf agent keyring: install / use / remove / list) -----

    def _install_key_locked(self, key: bytes) -> None:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        if key not in self._keys:
            self._keys.append(key)
            self._aeads.append(AESGCM(key))

    def _require_encryption(self) -> None:
        if not self._keys:
            raise ValueError("keyring operations require gossip encryption")

    def keyring_list(self) -> List[str]:
        import base64 as b64_mod

        with self._lock:
            return [b64_mod.b64encode(k).decode() for k in self._keys]

    def keyring_install(self, key: str) -> None:
        """Add a key to the ring (starts UNSEALING with it; the primary
        still seals)."""
        self._require_encryption()
        kb = _normalize_gossip_key(key, self.logger)
        with self._lock:
            self._install_key_locked(kb)

    def keyring_broadcast(self, op: str, key: str) -> None:
        """Apply a keyring op locally AND propagate it to the cluster
        (serf's keyring ops are cluster-wide queries): the op rides a
        sealed gossip message — only holders of a current ring key can
        rotate — and is also pushed directly to every alive member for
        promptness. Apply order matters for `use` (the sender must seal
        with the NEW key only after peers can unseal it), so operators
        still follow install-everywhere -> use -> remove-everywhere; this
        broadcast makes each step one call instead of N."""
        if op == "list":
            return
        import base64 as b64_mod
        import uuid as uuid_mod

        # seal the op with the CURRENT primary before applying `use`
        # locally, so peers that still hold only the old key can unseal
        mid = uuid_mod.uuid4().hex
        kb = _normalize_gossip_key(key, self.logger)
        with self._lock:
            self._keyring_clock += 1
            clock = self._keyring_clock
            self._key_clocks[kb] = max(self._key_clocks.get(kb, 0), clock)
            # our own rumor echoes back via peer rebroadcast: mark it
            # seen so it is not re-applied against ourselves
            self._keyring_seen[mid] = None
            while len(self._keyring_seen) > 256:
                self._keyring_seen.popitem(last=False)
        msg = {
            "t": "keyring", "op": op,
            "key": b64_mod.b64encode(kb).decode(),
            "id": mid,
            "c": clock,
        }
        targets = [m for m in self.alive_members() if m.name != self.config.name]
        for m in targets:
            self._send(m.addr, msg)
        self._queue_broadcast(msg)
        getattr(self, f"keyring_{op}")(key)

    def _on_keyring_msg(self, msg: dict) -> None:
        mid = msg.get("id", "")
        clock = msg.get("c")
        op = msg.get("op", "")
        if op not in ("install", "use", "remove"):
            return
        try:
            kb = _normalize_gossip_key(msg.get("key", ""), self.logger)
        except ValueError:
            return
        with self._lock:
            if mid in self._keyring_seen:
                return
            if clock is not None:
                # Lamport guards: a still-circulating rumor of an OLDER
                # ORDER-SENSITIVE op ('use'/'remove' — e.g. the previous
                # 'use' during a rotation) must never re-apply after
                # newer ops were seen; the bounded id-FIFO alone forgets
                # ids under rumor pressure. 'install' is order-free and
                # only guarded against resurrecting a key that a newer
                # remove deleted (per-key clock). Ties apply: concurrent
                # ops from distinct origins share a clock value and each
                # must land at least once.
                if op in ("use", "remove") and clock < self._keyring_clock:
                    return
                if op == "install" and clock < self._key_clocks.get(kb, 0):
                    return
        try:
            getattr(self, f"keyring_{op}")(msg.get("key", ""))
        except ValueError as e:
            # Apply failed (e.g. 'use' raced ahead of its 'install' in
            # rumor order): do NOT advance the clocks or mark the id
            # seen — the prerequisite rumor must still apply when it
            # arrives, and a retransmit of THIS rumor must retry.
            self.logger.warning("gossiped keyring %s failed: %s", op, e)
            return
        with self._lock:
            if clock is not None:
                self._keyring_clock = max(self._keyring_clock, clock)
                self._key_clocks[kb] = max(self._key_clocks.get(kb, 0), clock)
            self._keyring_seen[mid] = None
            while len(self._keyring_seen) > 256:
                self._keyring_seen.popitem(last=False)
        self._queue_broadcast(msg)  # keep the rumor moving

    def keyring_use(self, key: str) -> None:
        """Make an installed key the primary (sealing) key."""
        self._require_encryption()
        kb = _normalize_gossip_key(key, self.logger)
        with self._lock:
            if kb not in self._keys:
                raise ValueError("key is not installed in the keyring")
            i = self._keys.index(kb)
            self._keys.insert(0, self._keys.pop(i))
            self._aeads.insert(0, self._aeads.pop(i))

    def keyring_remove(self, key: str) -> None:
        self._require_encryption()
        kb = _normalize_gossip_key(key, self.logger)
        with self._lock:
            if kb not in self._keys:
                raise ValueError("key is not installed in the keyring")
            i = self._keys.index(kb)
            if i == 0:
                raise ValueError("cannot remove the primary key; use another first")
            self._keys.pop(i)
            self._aeads.pop(i)

    # -- wire helpers ----------------------------------------------------

    def _seal(self, data: bytes) -> bytes:
        """AES-GCM with a fresh 12-byte nonce per datagram (the serf
        encrypted-gossip wire: [version byte][nonce][ciphertext+tag]);
        the PRIMARY keyring key seals."""
        if not self._aeads:
            return data
        import os as os_mod

        nonce = os_mod.urandom(12)
        return b"\x01" + nonce + self._aeads[0].encrypt(nonce, data, b"")

    def _unseal(self, data: bytes) -> Optional[bytes]:
        if not self._aeads:
            return data
        if len(data) < 13 or data[0:1] != b"\x01":
            return None  # plaintext or foreign traffic: drop
        for aead in list(self._aeads):
            try:
                return aead.decrypt(data[1:13], data[13:], b"")
            except Exception:  # noqa: BLE001 — try the next ring key
                continue
        return None  # no ring key fits / tampered

    def _send(self, addr: Tuple[str, int], msg: dict) -> None:
        try:
            data = self._seal(wirefmt.packb(msg))
            if len(data) > MAX_DATAGRAM:
                self.logger.warning("dropping oversized gossip msg (%d bytes)", len(data))
                return
            self._sock.sendto(data, addr)
        except OSError:
            pass

    def _queue_broadcast(self, msg: dict) -> None:
        n = max(1, self.config.retransmit_mult * max(1, len(self.members)).bit_length())
        with self._lock:
            self._broadcasts.append([n, msg])

    def _with_gossip(self, msg: dict) -> dict:
        """Piggyback queued broadcasts onto an outgoing message."""
        with self._lock:
            gossip = []
            keep = []
            for entry in self._broadcasts:
                gossip.append(entry[1])
                entry[0] -= 1
                if entry[0] > 0:
                    keep.append(entry)
            self._broadcasts = keep
        if gossip:
            msg = dict(msg)
            msg["g"] = gossip
        return msg

    def _gossip_targets(self, k: int) -> List[Member]:
        with self._lock:
            others = [
                m for m in self.members.values()
                if m.name != self.config.name and m.status in (STATUS_ALIVE, STATUS_SUSPECT)
            ]
        random.shuffle(others)
        return others[:k]

    # -- listener --------------------------------------------------------

    def _listen_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                data, src = self._sock.recvfrom(65536)
            except OSError:
                return
            data = self._unseal(data)
            if data is None:
                self.logger.debug("dropping unauthenticated gossip from %s", src)
                continue
            try:
                msg = wirefmt.unpackb(data)
                self._handle(msg, src)
            except Exception:  # noqa: BLE001 — a bad datagram must not kill the loop
                self.logger.exception("bad gossip datagram from %s", src)

    def _handle(self, msg: dict, src: Tuple[str, int]) -> None:
        for rumor in msg.get("g", ()):
            self._handle(rumor, src)
        t = msg.get("t")
        if t == "ping":
            self._send(src, self._with_gossip({"t": "ack", "seq": msg["seq"]}))
        elif t == "ack":
            ev = self._acks.get(msg.get("seq"))
            if ev is not None:
                ev.set()
        elif t == "ping-req":
            # probe the target on behalf of the requester and relay the ack
            target = tuple(msg["target"])
            seq = msg["seq"]

            def relay():
                if self._ping(target):
                    self._send(src, {"t": "ack", "seq": seq})

            threading.Thread(target=relay, daemon=True).start()
        elif t == "alive":
            self._on_alive_msg(msg["member"])
        elif t == "suspect":
            self._on_suspect_msg(msg["name"], msg["inc"])
        elif t == "dead":
            self._on_dead_msg(msg["name"], msg["inc"], STATUS_DEAD)
        elif t == "leave":
            self._on_dead_msg(msg["name"], msg["inc"], STATUS_LEFT)
        elif t == "keyring":
            self._on_keyring_msg(msg)
        elif t == "push-pull":
            self._merge_remote_state(msg.get("members", []))
            self._merge_keyring_clock(msg.get("kc"))
            with self._lock:
                kc = self._keyring_clock
            self._send(src, {
                "t": "push-pull-ack",
                "seq": msg.get("seq"),
                "members": [m.to_wire() for m in self.all_members()],
                "kc": kc,
            })
        elif t == "push-pull-ack":
            self._merge_remote_state(msg.get("members", []))
            self._merge_keyring_clock(msg.get("kc"))
            ev = self._acks.get(msg.get("seq"))
            if ev is not None:
                ev.set()
        elif t == "compound":
            pass  # pure gossip carrier

    # -- state merging ---------------------------------------------------

    def _on_alive_msg(self, wire: dict) -> None:
        name = wire["name"]
        inc = wire["inc"]
        with self._lock:
            if name == self.config.name:
                # someone has stale info about us (wrong status, or a stale
                # address from before a restart); refute with higher inc
                if inc >= self.incarnation and (
                    wire.get("status") != STATUS_ALIVE
                    or (wire["host"], wire["port"]) != (self._local.host, self._local.port)
                ):
                    self._refute(inc)
                return
            cur = self.members.get(name)
            if cur is None:
                m = Member(
                    name=name, host=wire["host"], port=wire["port"],
                    tags=dict(wire.get("tags") or {}), incarnation=inc,
                )
                self.members[name] = m
                self._probe_ring.append(name)
                self._queue_broadcast({"t": "alive", "member": m.to_wire()})
                hook, arg = self.on_join, m
            elif inc > cur.incarnation or (
                inc == cur.incarnation and cur.status != STATUS_ALIVE
            ):
                was_dead = cur.status in (STATUS_DEAD, STATUS_LEFT, STATUS_SUSPECT)
                tags_changed = dict(wire.get("tags") or {}) != cur.tags
                if inc == cur.incarnation and cur.status == STATUS_DEAD:
                    # an equal-inc alive can't beat a dead rumor (SWIM rule);
                    # the member itself will refute with a higher inc
                    return
                cur.incarnation = inc
                cur.host, cur.port = wire["host"], wire["port"]
                cur.tags = dict(wire.get("tags") or {})
                cur.status = STATUS_ALIVE
                cur.status_change = time.monotonic()
                self._queue_broadcast({"t": "alive", "member": cur.to_wire()})
                hook = self.on_join if was_dead else (self.on_update if tags_changed else None)
                arg = cur
            else:
                return
        if hook is not None:
            try:
                hook(arg)
            except Exception:  # noqa: BLE001
                self.logger.exception("membership hook failed")

    def _on_suspect_msg(self, name: str, inc: int) -> None:
        with self._lock:
            if name == self.config.name:
                if inc >= self.incarnation:
                    self._refute(inc)
                return
            cur = self.members.get(name)
            if cur is None or inc < cur.incarnation or cur.status != STATUS_ALIVE:
                return
            cur.status = STATUS_SUSPECT
            cur.status_change = time.monotonic()
            self._queue_broadcast({"t": "suspect", "name": name, "inc": inc})

    def _on_dead_msg(self, name: str, inc: int, status: str) -> None:
        with self._lock:
            if name == self.config.name:
                # refute dead AND left rumors: a restarted instance must be
                # able to rejoin even after its predecessor left gracefully
                if inc >= self.incarnation:
                    self._refute(inc)
                return
            cur = self.members.get(name)
            if cur is None or inc < cur.incarnation:
                return
            if cur.status == STATUS_LEFT:
                return
            if cur.status == STATUS_DEAD and status != STATUS_LEFT:
                # dead -> LEFT is allowed: force-leave evicts failed
                # members (serf RemoveFailedNode); dead -> dead is noise
                return
            cur.status = status
            cur.incarnation = inc
            cur.status_change = time.monotonic()
            self._queue_broadcast(
                {"t": "dead" if status == STATUS_DEAD else "leave", "name": name, "inc": inc}
            )
            hook = self.on_leave if status == STATUS_LEFT else self.on_fail
        if hook is not None:
            try:
                hook(cur)
            except Exception:  # noqa: BLE001
                self.logger.exception("membership hook failed")

    def _refute(self, rumor_inc: int = 0) -> None:
        """Rumors of our demise: outbid the rumor's incarnation and
        re-broadcast alive. Caller holds the lock. Jumping past rumor_inc
        matters after a restart, when our own counter reset to 1 but the
        cluster remembers a higher one."""
        self.incarnation = max(self.incarnation, rumor_inc) + 1
        self._local.incarnation = self.incarnation
        self._local.status = STATUS_ALIVE
        self._queue_broadcast({"t": "alive", "member": self._local.to_wire()})

    def _merge_remote_state(self, wires: List[dict]) -> None:
        for wire in wires:
            status = wire.get("status", STATUS_ALIVE)
            if status == STATUS_ALIVE:
                self._on_alive_msg(wire)
            elif status == STATUS_SUSPECT:
                self._on_suspect_msg(wire["name"], wire["inc"])
            else:
                self._on_dead_msg(wire["name"], wire["inc"], status)

    # -- probing ---------------------------------------------------------

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _ping(self, addr: Tuple[str, int], timeout: Optional[float] = None) -> bool:
        seq = self._next_seq()
        ev = threading.Event()
        self._acks[seq] = ev
        try:
            self._send(addr, self._with_gossip({"t": "ping", "seq": seq}))
            return ev.wait(timeout or self.config.probe_timeout)
        finally:
            self._acks.pop(seq, None)

    def _merge_keyring_clock(self, kc) -> None:
        """Adopt the larger keyring lamport clock from push-pull state:
        a restarted node (clock reset to 0) would otherwise broadcast
        keyring ops with a clock every converged peer silently drops."""
        if not isinstance(kc, int):
            return
        with self._lock:
            self._keyring_clock = max(self._keyring_clock, kc)

    def _push_pull(self, addr: Tuple[str, int]) -> bool:
        seq = self._next_seq()
        ev = threading.Event()
        self._acks[seq] = ev
        try:
            with self._lock:
                kc = self._keyring_clock
            self._send(addr, {
                "t": "push-pull",
                "seq": seq,
                "members": [m.to_wire() for m in self.all_members()],
                "kc": kc,
            })
            return ev.wait(self.config.probe_timeout * 4)
        finally:
            self._acks.pop(seq, None)

    def _probe_loop(self) -> None:
        while not self._shutdown.wait(self.config.probe_interval):
            target = self._next_probe_target()
            if target is not None:
                self._probe(target)
            self._expire_suspects()
            self._reap_dead()

    def _next_probe_target(self) -> Optional[Member]:
        with self._lock:
            if not self._probe_ring:
                self._probe_ring = [
                    n for n, m in self.members.items()
                    if n != self.config.name and m.status in (STATUS_ALIVE, STATUS_SUSPECT)
                ]
                random.shuffle(self._probe_ring)
            while self._probe_ring:
                name = self._probe_ring.pop()
                m = self.members.get(name)
                if m is not None and m.status in (STATUS_ALIVE, STATUS_SUSPECT):
                    return m
        return None

    def _probe(self, member: Member) -> None:
        if self._ping(member.addr):
            return
        # indirect probes through k other members (SWIM ping-req)
        seq = self._next_seq()
        ev = threading.Event()
        self._acks[seq] = ev
        try:
            relays = [m for m in self._gossip_targets(self.config.indirect_checks)
                      if m.name != member.name]
            for relay in relays:
                self._send(relay.addr, {
                    "t": "ping-req", "seq": seq, "target": list(member.addr),
                })
            if relays and ev.wait(self.config.probe_timeout * 3):
                return
        finally:
            self._acks.pop(seq, None)
        self._on_suspect_msg(member.name, member.incarnation)

    def _expire_suspects(self) -> None:
        now = time.monotonic()
        expired = []
        with self._lock:
            for m in self.members.values():
                if m.status == STATUS_SUSPECT and (
                    now - m.status_change > self.config.suspicion_timeout
                ):
                    expired.append((m.name, m.incarnation))
        for name, inc in expired:
            self._on_dead_msg(name, inc, STATUS_DEAD)

    def _reap_dead(self) -> None:
        now = time.monotonic()
        with self._lock:
            for name in list(self.members):
                m = self.members[name]
                if m.status in (STATUS_DEAD, STATUS_LEFT) and (
                    now - m.status_change > self.config.dead_reclaim_time
                ):
                    del self.members[name]

    def _push_pull_loop(self) -> None:
        while not self._shutdown.wait(self.config.push_pull_interval):
            targets = self._gossip_targets(1)
            if targets:
                self._push_pull(targets[0].addr)
