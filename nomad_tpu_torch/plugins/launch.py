"""Plugin subprocess entrypoint.

``python -m nomad_tpu_torch.plugins.launch driver <name>`` serves a
built-in driver out-of-process; ``... device <module>:<attr>`` serves a
device plugin factory. External plugin executables are free to call
``transport.serve_main`` themselves — this module is the built-in shim
(the role of the reference's plugin main() + go-plugin Serve).

Copied from ``nomad_tpu/plugins/launch.py`` into the PyTorch port, which
imports nothing of ``nomad_tpu``. Changes: ``plugin_env``, the
subprocess environment (the reference's ``catalog._plugin_env``), lives
here, where the device plugins' callers and the catalog both import it.
"""
from __future__ import annotations

import importlib
import os
import sys


def plugin_env() -> dict:
    """Subprocess env: make the port importable from the repo root."""
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def main(argv) -> int:
    if len(argv) < 2:
        print("usage: launch driver <name> | device <module>:<attr>", file=sys.stderr)
        return 2
    kind, target = argv[0], argv[1]
    if kind == "driver":
        from ..client.drivers import new_driver  # package import registers built-ins
        from .driver_plugin import DriverPluginShim
        from .transport import serve_main

        serve_main(DriverPluginShim(new_driver(target)))
    elif kind == "device":
        module_name, _, attr = target.partition(":")
        module = importlib.import_module(module_name)
        factory = getattr(module, attr or "plugin")
        from .device import DevicePluginShim
        from .transport import serve_main

        serve_main(DevicePluginShim(factory()))
    else:
        print(f"unknown plugin kind {kind!r}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
