"""rpc-telemetry-discipline: RPC traffic must stay observable.

The transport's telemetry and tracing (nomad-xtrace) hang off exactly
two choke points: ``RPCServer.register`` / ``register_endpoint`` feed
the handler table whose dispatch loop records per-method latency
histograms and opens server spans, and ``RPCClient.call`` stamps the
outbound ``TraceContext`` into the envelope's ``trace`` field and opens
the client span. Code that slips around either choke point produces
RPCs that are invisible — no ``nomad.rpc.<method>.*`` series, no span,
a hole in every stitched trace. Three obligations everywhere outside
the transport itself:

  1. no raw handler-table inserts: ``<server>.handlers[...] = fn``
     bypasses ``register()`` (today they are equivalent, but the
     registry is the documented seam where per-method instrumentation
     attaches — and the stats table is BOUNDED by it);
  2. no reaching for the private frame plumbing: importing or calling
     ``_send_frame`` / ``_recv_frame`` / ``_read_exact`` builds a side
     channel the telemetry never sees;
  3. no hand-built request envelopes: a dict literal carrying both
     ``"seq"`` and ``"method"`` keys is wire-format assembly — those
     frames skip ``RPCClient.call`` and therefore never carry the
     TraceContext, so the receiving server span becomes a trace root
     and the cross-process tree silently splits.

Exempt: ``rpc/transport.py`` (it IS the choke point) and
``plugins/transport.py`` (the external-plugin frame protocol speaks the
same framing by design but is not a server RPC — plugin calls are
in-process children of the worker's span).

Copied from ``nomad_tpu/analysis/rpc_telemetry_discipline.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``; its path keys name
``nomad_tpu_torch/``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .core import Finding, ParsedModule, import_aliases, resolve_call_name

RULE = "rpc-telemetry-discipline"

#: the transport's private frame plumbing — any use outside the exempt
#: modules is a telemetry-invisible side channel
_PRIVATE_FRAME_FNS = {"_send_frame", "_recv_frame", "_read_exact"}

#: a dict literal with BOTH keys is a hand-assembled request envelope
_ENVELOPE_KEYS = {"seq", "method"}

_EXEMPT = ("rpc/transport.py", "plugins/transport.py")


def _dict_literal_keys(node: ast.Dict) -> set:
    keys = set()
    for k in node.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.add(k.value)
    return keys


class RpcTelemetryDisciplineChecker:
    rule = RULE

    def collect(self, module: ParsedModule) -> None:  # single-pass rule
        pass

    def check(self, module: ParsedModule) -> List[Finding]:
        if module.rel.endswith(_EXEMPT):
            return []
        aliases = import_aliases(module.tree)
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            self._check_handler_insert(module, node, findings)
            self._check_frame_import(module, node, findings)
            self._check_frame_call(module, node, aliases, findings)
            self._check_envelope_literal(module, node, findings)
        return findings

    # -- 1: raw handler-table inserts -----------------------------------

    def _check_handler_insert(self, module: ParsedModule, node: ast.AST,
                              findings: List[Finding]) -> None:
        if not isinstance(node, ast.Assign):
            return
        for target in node.targets:
            if not isinstance(target, ast.Subscript):
                continue
            base = target.value
            if isinstance(base, ast.Attribute) and base.attr == "handlers":
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    "raw handler-table insert bypasses RPCServer.register()"
                    " — the registry is where per-method telemetry and"
                    " server spans attach (and what bounds the stats"
                    " table)",
                ))

    # -- 2: private frame plumbing --------------------------------------

    def _check_frame_import(self, module: ParsedModule, node: ast.AST,
                            findings: List[Finding]) -> None:
        if not isinstance(node, ast.ImportFrom):
            return
        mod = node.module or ""
        if not mod.endswith("transport"):
            return
        for alias in node.names:
            if alias.name in _PRIVATE_FRAME_FNS:
                findings.append(Finding(
                    RULE, module.rel, node.lineno,
                    f"importing transport.{alias.name} builds a frame"
                    f" side channel the RPC telemetry never sees — go"
                    f" through RPCClient.call / RPCServer.register",
                ))

    def _check_frame_call(self, module: ParsedModule, node: ast.AST,
                          aliases: Dict[str, str],
                          findings: List[Finding]) -> None:
        if not isinstance(node, ast.Call):
            return
        name = resolve_call_name(node.func, aliases)
        if name is None:
            return
        parts = name.split(".")
        # require a transport qualifier: a module's OWN helper that
        # happens to share the name (agent/websocket.py frames its own
        # protocol) is not the RPC side channel this rule bans — the
        # import check above still catches `from ...transport import x`
        if (parts[-1] in _PRIVATE_FRAME_FNS and len(parts) >= 2
                and parts[-2].lstrip("_").endswith("transport")):
            findings.append(Finding(
                RULE, module.rel, node.lineno,
                f"direct transport.{parts[-1]}() call skips the"
                f" instrumented RPC path (no latency row, no span)",
            ))

    # -- 3: hand-built envelopes ----------------------------------------

    def _check_envelope_literal(self, module: ParsedModule, node: ast.AST,
                                findings: List[Finding]) -> None:
        if not isinstance(node, ast.Dict):
            return
        if _ENVELOPE_KEYS <= _dict_literal_keys(node):
            findings.append(Finding(
                RULE, module.rel, node.lineno,
                "hand-built RPC envelope ({'seq', 'method', ...} dict"
                " literal) skips RPCClient.call, so it carries no"
                " TraceContext — the receiving span becomes a trace root"
                " and the stitched tree splits",
            ))
