"""The store-backend side of ``repro.core.sanitize`` that the port needs.

Only :func:`unwrap_backend` for now: the sanitizer itself
(``SanitizingBackend``, ``SanitizingSink``, ``check_footprint`` and
``REPRO_SANITIZE``) is ROADMAP.md item 9b.
"""
from __future__ import annotations

from repro_torch.core.store import StoreBackend


def unwrap_backend(backend: StoreBackend) -> StoreBackend:
    """The real backend behind any proxy layers (retrying, throttling,
    fault-injecting), each of which holds the wrapped backend as
    ``.inner``: what the build dispatches on for the backend's residency
    regime."""
    depth = 0
    while "inner" in getattr(backend, "__dict__", ()) and depth < 32:
        backend = backend.inner
        depth += 1
    return backend
