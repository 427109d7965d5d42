"""Lockdep sanitizer: runtime lock-order tracking behind a factory.

The warehouse holds ~20 locks across sharded WLM admission, the query
scheduler, per-edge exchanges, the serving tier, the metastore, and LLAP.
A lock-order inversion between any two of them surfaces in production as a
rare CI hang; this module makes it a deterministic, immediate failure
instead — the Linux-kernel lockdep idea scaled down to this runtime:

  * locks are created through :func:`make_lock` / :func:`make_rlock` /
    :func:`make_condition` with a *class name* (``"wlm.shard"``,
    ``"exchange"``, ...).  With ``REPRO_LOCKDEP`` unset in the environment
    the factories return plain :mod:`threading` primitives — zero overhead,
    byte-identical behavior;
  * with ``REPRO_LOCKDEP=1`` they return tracked wrappers that maintain a
    per-thread held-lock set and a global *acquisition-order graph* over
    lock class names.  Acquiring ``B`` while holding ``A`` records the edge
    ``A -> B``; an acquisition whose new edge would close a cycle raises
    :class:`LockOrderError` **at acquire time**, before any thread blocks —
    one AB + one BA acquisition anywhere in the process's history is
    enough, no actual interleaving race required.

Conditions built over tracked locks stay tracked (``threading.Condition``
delegates ``acquire``/``release``/``_release_save``/``_acquire_restore`` to
the lock object), and a ``wait()`` correctly drops the lock from the held
set for its duration.

Same-class edges (one exchange's condition acquired while holding another
exchange's) are recorded but never treated as cycles: lane arrays create
thousands of same-class siblings that are only ever held one at a time, and
instance-level ordering among them is meaningless.  A genuine same-class
nesting discipline would need explicit nesting annotations (kernel
``mutex_lock_nested``); nothing in this runtime holds two same-class locks.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set

ENV_FLAG = "REPRO_LOCKDEP"


def enabled() -> bool:
    return bool(os.environ.get(ENV_FLAG))


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the lock-order graph."""

    def __init__(self, holding: str, acquiring: str, path: List[str],
                 held_now: List[str]):
        self.holding = holding
        self.acquiring = acquiring
        self.path = path
        # path runs acquiring -> ... -> holding; the new holding->acquiring
        # edge closes the cycle
        chain = " -> ".join(path + [acquiring])
        super().__init__(
            f"lock-order inversion: acquiring {acquiring!r} while holding "
            f"{holding!r}, but the acquisition-order graph already has "
            f"{chain} (held now: {held_now})"
        )


class _Graph:
    """The global acquisition-order graph over lock class names."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> set of names acquired while name was held
        self._edges: Dict[str, Set[str]] = {}
        # (a, b) -> "where" string of the first time the edge was seen
        self._sites: Dict[tuple, str] = {}

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._sites.clear()

    def snapshot(self) -> Dict[str, Set[str]]:
        with self._lock:
            return {k: set(v) for k, v in self._edges.items()}

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src -> ... -> dst in the edge set, or None.  Caller holds
        the graph lock."""
        stack, parent = [src], {src: None}
        while stack:
            n = stack.pop()
            if n == dst:
                out, cur = [], dst
                while cur is not None:
                    out.append(cur)
                    cur = parent[cur]
                return list(reversed(out))
            for m in self._edges.get(n, ()):
                if m not in parent:
                    parent[m] = n
                    stack.append(m)
        return None

    def note_acquire(self, held: List["TrackedLock"],
                     acquiring: "TrackedLock") -> None:
        """Record held->acquiring edges; raise on a would-be cycle."""
        new = acquiring.lock_name
        with self._lock:
            for h in held:
                a = h.lock_name
                if a == new:
                    continue  # same-class siblings: see module docstring
                if new not in self._edges.get(a, ()):
                    # would a -> new close a cycle?  (new ->* a exists)
                    path = self._path(new, a)
                    if path is not None:
                        raise LockOrderError(a, new, path,
                                             [x.lock_name for x in held])
                    self._edges.setdefault(a, set()).add(new)
                    self._sites.setdefault((a, new), _caller_site())


def _caller_site() -> str:
    import traceback

    for frame in reversed(traceback.extract_stack(limit=12)):
        fn = frame.filename
        if "analysis/lockdep" not in fn.replace(os.sep, "/"):
            return f"{fn}:{frame.lineno}"
    return "?"


_GRAPH = _Graph()
_STATE = threading.local()


def _held() -> Dict[int, list]:
    """Per-thread held map: id(lock) -> [lock, depth]."""
    try:
        return _STATE.held
    except AttributeError:
        _STATE.held = {}
        return _STATE.held


def reset() -> None:
    """Clear the global order graph (test isolation)."""
    _GRAPH.reset()


def graph_snapshot() -> Dict[str, Set[str]]:
    return _GRAPH.snapshot()


class TrackedLock:
    """A named, order-tracked wrapper over ``threading.Lock``/``RLock``.

    Exposes the full lock protocol (including the ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` trio ``threading.Condition`` uses),
    so it can stand anywhere the plain primitive did.
    """

    _reentrant = False

    def __init__(self, name: str, inner=None):
        self.lock_name = name
        self._inner = inner if inner is not None else threading.Lock()

    # ------------------------------------------------------------- tracking
    def _before_acquire(self) -> None:
        held = _held()
        ent = held.get(id(self))
        if ent is not None and self._reentrant:
            return  # reentrant re-acquire: no new edges
        _GRAPH.note_acquire([e[0] for e in held.values() if e[1] > 0], self)

    def _note_acquired(self) -> None:
        held = _held()
        ent = held.setdefault(id(self), [self, 0])
        ent[1] += 1

    def _note_released(self, full: bool = False) -> None:
        held = _held()
        ent = held.get(id(self))
        if ent is None:
            return
        ent[1] = 0 if full else ent[1] - 1
        if ent[1] <= 0:
            del held[id(self)]

    # ------------------------------------------------------------- protocol
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._before_acquire()
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._inner.release()
        self._note_released()

    def __enter__(self):
        self.acquire()  # repro-lint: REP004 — the wrapper IS the protocol
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # Condition protocol: wait() fully releases the lock — drop it from the
    # held set for the wait's duration so cross-thread edges stay truthful
    def _release_save(self):
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        self._note_released(full=True)
        return state

    def _acquire_restore(self, state) -> None:
        self._before_acquire()
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()  # repro-lint: REP004 — protocol internals
        self._note_acquired()

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        ent = _held().get(id(self))
        return ent is not None and ent[1] > 0

    def __repr__(self):
        return f"<{type(self).__name__} {self.lock_name!r}>"


class TrackedRLock(TrackedLock):
    _reentrant = True

    def __init__(self, name: str):
        super().__init__(name, threading.RLock())


class TrackedCondition(threading.Condition):
    """``threading.Condition`` over a tracked lock.

    ``Condition`` binds ``acquire``/``release`` straight to the lock object
    and uses its ``_release_save``/``_acquire_restore`` during ``wait``, so
    every entry/exit and every wait-side release/reacquire flows through
    the tracking in :class:`TrackedLock` with no further overrides here.
    """

    def __init__(self, lock=None, name: str = "condition"):
        if lock is None:
            lock = TrackedRLock(f"{name}.lock")
        elif not isinstance(lock, TrackedLock):
            raise TypeError(
                "TrackedCondition requires a tracked lock (make_lock / "
                "make_rlock), got %r" % (lock,)
            )
        super().__init__(lock)


# ===========================================================================
# the factory: zero-overhead plain primitives unless REPRO_LOCKDEP is set
# ===========================================================================
def make_lock(name: str):
    """A mutex of lock-class ``name`` (plain ``threading.Lock`` when
    lockdep is off)."""
    return TrackedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str):
    return TrackedRLock(name) if enabled() else threading.RLock()


def make_condition(lock=None, name: str = "condition"):
    """A condition variable over ``lock`` (created if None).

    When lockdep is enabled and ``lock`` is an untracked primitive (or
    None), a tracked lock of class ``name`` is created instead, so the
    condition's waits/notifies participate in order checking.
    """
    if not enabled():
        return threading.Condition(lock)
    if lock is None or not isinstance(lock, TrackedLock):
        lock = TrackedRLock(f"{name}.lock")
    return TrackedCondition(lock, name=name)
