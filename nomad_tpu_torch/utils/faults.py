"""The exception type of a deliberately injected fault.

``chaos.injector.ChaosFault`` subclasses :class:`InjectedFault`. It lives
outside ``chaos/`` so that production code can tell an injected fault
from a real one without importing the chaos harness (the
``fault-injection-discipline`` lint rule): the engine degrades an
injected ``device_dispatch`` fault to the host path and lets every real
device fault raise.
"""
from __future__ import annotations


class InjectedFault(RuntimeError):
    """A fault raised on purpose at an armed injection point."""
