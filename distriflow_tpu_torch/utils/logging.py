"""Port of ``distriflow_tpu/utils/logging.py`` (copied with its imports rewritten).

Logging, timing, and callback observability.

Re-design of the reference's prefixed-console-log + wall-clock ``time()``
helpers and callback registries (``src/server/abstract_server.ts:67-103``,
``src/client/abstract_client.ts:90-180``):

- ``VerboseLogger``: ``verbose`` flag from config or ``VERBOSE`` env var
  (reference ``federated_server.ts:45-47``) gating prefixed logs.
- ``timed``: context manager logging ``"<msg> took Nms"`` — the reference's
  only tracing facility.
- ``CallbackRegistry``: ``on_new_version`` / ``on_upload`` style hooks
  (reference ``abstract_server.ts:67-79``).
"""

from __future__ import annotations

import contextlib
import os
import time as _time
from typing import Any, Callable, Dict, List


class VerboseLogger:
    """Prefixed logger gated on a verbose flag (reference ``abstract_server.ts:92-96``)."""

    def __init__(self, prefix: str, verbose: bool | None = None):
        self.prefix = prefix
        if verbose is None:
            verbose = os.environ.get("VERBOSE", "").lower() not in ("", "0", "false", "no")
        self.verbose = verbose

    def log(self, *args: Any) -> None:
        if self.verbose:
            print(f"[{self.prefix}]", *args, flush=True)

    @contextlib.contextmanager
    def time(self, msg: str):
        """Log ``"<msg> took Nms"`` (reference ``abstract_server.ts:98-103``)."""
        start = _time.perf_counter()
        try:
            yield
        finally:
            elapsed_ms = (_time.perf_counter() - start) * 1e3
            self.log(f"{msg} took {elapsed_ms:.1f}ms")


class CallbackRegistry:
    """Named lists of callbacks (reference ``onNewVersion``/``onUpload`` registries)."""

    def __init__(self, *names: str):
        self._callbacks: Dict[str, List[Callable[..., Any]]] = {n: [] for n in names}

    def register(self, name: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        if name not in self._callbacks:
            raise KeyError(f"unknown callback event {name!r}; valid: {sorted(self._callbacks)}")
        self._callbacks[name].append(fn)
        return fn

    def has(self, name: str) -> bool:
        """True when any callback is registered for ``name`` — lets hot
        paths skip building expensive arguments (e.g. device fetches)."""
        if name not in self._callbacks:  # same validation as fire(): a
            # typo'd guard must fail loudly, not silently disable the branch
            raise KeyError(f"unknown callback event {name!r}; valid: {sorted(self._callbacks)}")
        return bool(self._callbacks[name])

    def fire(self, name: str, *args: Any, **kw: Any) -> None:
        if name not in self._callbacks:
            raise KeyError(f"unknown callback event {name!r}; valid: {sorted(self._callbacks)}")
        for fn in self._callbacks[name]:
            fn(*args, **kw)

    def on(self, name: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            return self.register(name, fn)

        return deco
