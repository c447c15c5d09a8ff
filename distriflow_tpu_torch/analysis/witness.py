"""Port of ``distriflow_tpu/analysis/witness.py`` (copied with its imports rewritten).

Runtime lock-order witness: the dynamic counterpart of dfcheck's static
lock-acquisition graph.

``ordered_lock(name)`` is a drop-in ``threading.Lock`` factory.  With the
witness disabled (the default) it returns a plain ``threading.Lock`` —
zero overhead, zero behavior change.  With ``DISTRIFLOW_LOCK_WITNESS=1``
(or ``enabled=True``) it returns an :class:`OrderedLock` that maintains a
process-global acquisition-order graph: acquiring B while holding A records
the edge ``A -> B`` together with the acquiring thread's stack; if the
reverse edge ``B -> A`` is already on record — from ANY thread — the
acquire raises :class:`LockOrderViolation` carrying both stacks, i.e. the
inversion the static graph predicts is caught at the first runtime
occurrence rather than at the (probabilistic) deadlock.

The witness intentionally detects *potential* deadlocks: the two
conflicting acquisitions need not overlap in time.  That is what makes the
doctor drill deterministic — a scripted inversion on one thread raises
exactly once, with no timing window to hit.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple, Union

ENV_VAR = "DISTRIFLOW_LOCK_WITNESS"


class LockOrderViolation(RuntimeError):
    """Acquiring ``inner`` while holding ``outer`` inverts a recorded edge."""

    def __init__(self, outer: str, inner: str, prior_stack: str, this_stack: str):
        self.outer = outer
        self.inner = inner
        self.prior_stack = prior_stack
        self.this_stack = this_stack
        super().__init__(
            f"lock-order inversion: acquiring {inner!r} while holding {outer!r}, "
            f"but the order {inner!r} -> {outer!r} was previously recorded\n"
            f"--- prior acquisition stack ({inner!r} -> {outer!r}) ---\n"
            f"{prior_stack}"
            f"--- this acquisition stack ({outer!r} -> {inner!r}) ---\n"
            f"{this_stack}"
        )


class _WitnessState:
    """Process-global order graph + per-thread held stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        #: (outer, inner) -> formatted stack of the acquisition that recorded it
        self.edges: Dict[Tuple[str, str], str] = {}
        self._tls = threading.local()

    def held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def note_acquire(self, name: str) -> None:
        held = self.held()
        if held:
            stack_txt = "".join(traceback.format_stack(limit=16)[:-2])
            if name in held:
                # non-reentrant self-acquire: a guaranteed deadlock
                raise LockOrderViolation(name, name, "(same thread)\n", stack_txt)
            outer = held[-1]
            with self._mu:
                prior = self.edges.get((name, outer))
                if prior is not None:
                    raise LockOrderViolation(outer, name, prior, stack_txt)
                self.edges.setdefault((outer, name), stack_txt)
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self.held()
        # release order may differ from acquisition order; remove last match
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()


#: module-global state — one order graph per process, like a real witness
_STATE = _WitnessState()


def reset_witness() -> None:
    """Clear the recorded order graph (tests / doctor drills)."""
    _STATE.reset()


class OrderedLock:
    """A ``threading.Lock`` wrapper that feeds the witness on every
    acquire/release — non-reentrant, matching production lock semantics
    (a same-thread re-acquire raises instead of silently deadlocking)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _STATE.note_acquire(self.name)
        try:
            got = self._lock.acquire(blocking, timeout)
        except BaseException:
            _STATE.note_release(self.name)
            raise
        if not got:
            _STATE.note_release(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        _STATE.note_release(self.name)

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"OrderedLock({self.name!r})"


def witness_enabled() -> bool:
    return os.environ.get(ENV_VAR, "").strip() not in ("", "0", "false", "off")


def ordered_lock(
    name: str, enabled: Optional[bool] = None
) -> Union[OrderedLock, "threading.Lock"]:
    """Factory: a witnessed :class:`OrderedLock` when the witness is on,
    else a plain ``threading.Lock()`` (zero overhead, zero behavior change
    off — production semantics are identical)."""
    if enabled is None:
        enabled = witness_enabled()
    if enabled:
        return OrderedLock(name)
    return threading.Lock()


# ---------------------------------------------------------------------------
# pool-conservation witness
# ---------------------------------------------------------------------------

POOL_ENV_VAR = "DISTRIFLOW_POOL_WITNESS"


class PoolConservationViolation(AssertionError):
    """Raised when free + referenced + shared pages != pool size: pages were
    leaked (never released) or double-released somewhere in the serving
    engine.  Subclasses AssertionError so an enabled witness fails tests
    loudly rather than logging."""


def pool_witness_enabled() -> bool:
    return os.environ.get(POOL_ENV_VAR, "").strip() not in (
        "", "0", "false", "off")


class PoolWitness:
    """Runtime counterpart of the resource family's static page-pool proofs.

    At quiescence points (idle scheduler tick, ``stop()``, prefix-cache
    flush) the serving engine reports its page accounting and the witness
    asserts the conservation identity::

        free + referenced + shared == pool size

    where *shared* counts pages held only by the prefix cache and
    *referenced* counts pages held by live slots (a page both slot-held and
    prefix-shared counts once, as referenced).  With the witness disabled
    (the default) ``verify`` is a no-op, so production pays one branch.
    """

    def __init__(self, n_pages: int, enabled: Optional[bool] = None):
        self.n_pages = int(n_pages)
        self.enabled = pool_witness_enabled() if enabled is None else enabled
        self.checks = 0
        self.trips = 0

    def verify(self, free: int, referenced: int, shared: int,
               context: str = "") -> None:
        if not self.enabled:
            return
        self.checks += 1
        total = free + referenced + shared
        if total != self.n_pages:
            self.trips += 1
            where = f" at {context}" if context else ""
            raise PoolConservationViolation(
                f"page-pool conservation violated{where}: "
                f"free={free} + referenced={referenced} + shared={shared} "
                f"= {total}, pool size {self.n_pages} "
                f"({'leaked' if total < self.n_pages else 'double-counted'} "
                f"{abs(self.n_pages - total)} page(s))")
