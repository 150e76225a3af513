"""Template rendering hook — the consul-template slot (reference
client/allocrunner/taskrunner/template/template.go:1-80, registered at
task_runner_hooks.go:80-90).

A task's ``template`` stanzas render Consul KV values and Vault secrets
into files under the task directory, re-render when the upstream values
change, and apply the stanza's ``change_mode``:

  noop     leave the running task alone
  restart  restart the task (the default)
  signal   send ``change_signal`` to the task

Template language: a documented subset of consul-template's function
set (full Go text/template is out of scope for this runtime):

  {{ key "path" }}             Consul KV value (blocks until present,
                               like consul-template's dependency wait)
  {{ secret "path" "field" }}  Vault secret field (KV-v1 GET /v1/<path>)
  {{ env "NAME" }}             task environment variable

plus ``${...}`` task-env interpolation applied to source/destination
paths. ``data`` provides inline template text; ``source`` names a file
(task-dir relative). ``destination`` is task-dir relative; ``perms`` is
an octal string (e.g. "600"); ``splay``/poll interval via the hook.

Copied from ``nomad_tpu/client/template.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Change: the logger is
``nomad_tpu_torch.client.template``.
"""
from __future__ import annotations

import logging
import os
import re
import threading
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("nomad_tpu_torch.client.template")

_FUNC_RE = re.compile(
    r"\{\{\s*(key|secret|env)\s+\"([^\"]+)\"(?:\s+\"([^\"]+)\")?\s*\}\}"
)

DEFAULT_POLL_S = 0.5


class TemplateError(Exception):
    """Render failure — fails/blocks the task like consul-template."""


class TemplateHook:
    """Renders a task's template stanzas and watches for changes.

    ``restart_cb``/``signal_cb`` apply change modes; ``consul`` is a
    ConsulClient (or None), ``vault_read`` a callable(path) -> dict.
    """

    def __init__(self, templates: List[Dict], task_root: str,
                 consul=None, vault_read: Optional[Callable] = None,
                 env_fn: Optional[Callable[[], Dict[str, str]]] = None,
                 interp: Optional[Callable[[str], str]] = None,
                 restart_cb: Optional[Callable[[], None]] = None,
                 signal_cb: Optional[Callable[[str], None]] = None,
                 poll_interval: float = DEFAULT_POLL_S,
                 block_timeout: float = 30.0,
                 stop_event: Optional[threading.Event] = None) -> None:
        self.templates = templates or []
        self.task_root = task_root
        self.consul = consul
        self.vault_read = vault_read
        self.env_fn = env_fn or (lambda: {})
        self.interp = interp or (lambda s: s)
        self.restart_cb = restart_cb
        self.signal_cb = signal_cb
        self.poll_interval = poll_interval
        self.block_timeout = block_timeout
        self._rendered: Dict[int, str] = {}
        # the caller may supply its kill event so a task kill interrupts
        # the prestart dependency wait immediately
        self._stop = stop_event if stop_event is not None else threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- rendering -------------------------------------------------------

    def _template_text(self, tpl: Dict) -> str:
        if tpl.get("data"):
            return str(tpl["data"])
        source = self.interp(str(tpl.get("source", "")))
        if not source:
            raise TemplateError("template has neither data nor source")
        path = source if os.path.isabs(source) else os.path.join(self.task_root, source)
        with open(path) as f:
            return f.read()

    def _resolve(self, func: str, arg: str, field: Optional[str]):
        """One template function call; None = dependency missing (block)."""
        if func == "key":
            if self.consul is None:
                raise TemplateError("template uses {{ key }} but consul is not configured")
            return self.consul.kv_get(arg)
        if func == "secret":
            if self.vault_read is None:
                raise TemplateError("template uses {{ secret }} but vault is not configured")
            try:
                data = self.vault_read(arg)
            except Exception as e:  # noqa: BLE001
                # a MISSING secret blocks (dependency wait); auth/transport
                # errors are permanent — surface them instead of a
                # misleading dependency timeout
                if "404" in str(e):
                    return None
                raise TemplateError(f"vault read {arg!r} failed: {e}") from e
            if data is None:
                return None
            if field:
                return data.get(field)
            if len(data) == 1:
                return next(iter(data.values()))
            raise TemplateError(
                f"secret {arg!r} has multiple fields; name one: {sorted(data)}"
            )
        if func == "env":
            return self.env_fn().get(arg, "")
        raise TemplateError(f"unknown template function {func!r}")

    def render_once(self, tpl: Dict) -> Optional[str]:
        """Rendered content, or None when a dependency is missing."""
        text = self._template_text(tpl)
        missing: List[str] = []

        def sub(m: re.Match) -> str:
            val = self._resolve(m.group(1), m.group(2), m.group(3))
            if val is None:
                missing.append(m.group(2))
                return ""
            return str(val)

        out = _FUNC_RE.sub(sub, text)
        if missing:
            return None
        return out

    def _write(self, tpl: Dict, content: str) -> str:
        dest_rel = self.interp(str(tpl.get("destination", "")))
        if not dest_rel:
            raise TemplateError("template has no destination")
        dest = os.path.realpath(os.path.join(self.task_root, dest_rel))
        root = os.path.realpath(self.task_root)
        if dest != root and not dest.startswith(root + os.sep):
            raise TemplateError(f"template destination escapes task dir: {dest_rel}")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "w") as f:
            f.write(content)
        perms = str(tpl.get("perms", "") or "")
        if perms:
            os.chmod(dest, int(perms, 8))
        return dest

    def prestart(self) -> None:
        """Initial render of every template; blocks (polling) until every
        dependency exists, up to ``block_timeout`` — consul-template's
        dependency wait."""
        deadline = None
        pending = list(enumerate(self.templates))
        while pending:
            still = []
            for i, tpl in pending:
                content = self.render_once(tpl)
                if content is None:
                    still.append((i, tpl))
                    continue
                self._write(tpl, content)
                self._rendered[i] = content
            if not still:
                return
            import time as _time

            if deadline is None:
                deadline = _time.monotonic() + self.block_timeout
            if _time.monotonic() >= deadline:
                raise TemplateError(
                    "timed out waiting for template dependencies: "
                    f"{[t.get('destination') for _, t in still]}"
                )
            if self._stop.wait(self.poll_interval):
                raise TemplateError("task stopping")
            pending = still

    # -- change watching -------------------------------------------------

    def start_watcher(self) -> None:
        if not self.templates:
            return
        self._thread = threading.Thread(
            target=self._watch_loop, name="template-watcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            restart = False
            signals: List[str] = []
            for i, tpl in enumerate(self.templates):
                try:
                    content = self.render_once(tpl)
                except Exception as e:  # noqa: BLE001 — watcher must survive
                    logger.warning("template re-render failed: %s", e)
                    continue
                if content is None or content == self._rendered.get(i):
                    continue
                try:
                    self._write(tpl, content)
                except Exception as e:  # noqa: BLE001
                    logger.warning("template write failed: %s", e)
                    continue
                self._rendered[i] = content
                mode = str(tpl.get("change_mode", "restart") or "restart")
                if mode == "restart":
                    restart = True
                elif mode == "signal":
                    signals.append(str(tpl.get("change_signal", "SIGHUP")))
                # noop: just the re-render
            # coalesce: one restart beats any number of signals
            # (template.go change-mode application)
            if restart and self.restart_cb is not None:
                self.restart_cb()
            elif signals and self.signal_cb is not None:
                for sig in signals:
                    self.signal_cb(sig)
