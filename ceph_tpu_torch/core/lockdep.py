"""lockdep — runtime lock-order-cycle detection over named mutexes.

The port's copy of ``ceph_tpu.core.lockdep``.

Reference behavior re-created (``src/common/lockdep.cc`` +
``src/common/ceph_mutex.h``; SURVEY.md §6.2): every mutex is NAMED;
when lockdep is enabled, acquiring B while holding A records the
edge A→B in a global order graph, and an acquisition that would
close a cycle (B→…→A while holding A, then taking B… wait, taking A
while an A→…→B path exists and B is held) raises immediately with
both chains — turning a would-be deadlock that needs unlucky timing
into a deterministic failure on ANY interleaving that uses the two
orders.  Re-acquiring a held mutex (non-recursive) is also caught.

Enable per test/daemon via ``lockdep_enable()`` (the reference's
``lockdep = true`` config); zero overhead when disabled.
"""

from __future__ import annotations

import threading

_state = threading.local()
_graph_lock = threading.Lock()
# edge held_name → {acquired_name: (holder_stack_hint, ...)}
_edges: dict[str, set[str]] = {}
_enabled = False


class LockOrderError(RuntimeError):
    pass


def lockdep_enable():
    global _enabled
    _enabled = True


def lockdep_disable():
    global _enabled
    _enabled = False
    with _graph_lock:
        _edges.clear()


def _held() -> list[str]:
    if not hasattr(_state, "held"):
        _state.held = []
    return _state.held


def _path_exists(src: str, dst: str) -> list[str] | None:
    """DFS src→dst in the recorded order graph (holding _graph_lock)."""
    stack, seen = [(src, [src])], {src}
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def will_lock(name: str):
    """Called before blocking on `name`; raises on ordering cycles."""
    if not _enabled:
        return
    held = _held()
    if name in held:
        raise LockOrderError(
            f"recursive acquisition of non-recursive mutex {name!r} "
            f"(held: {held})")
    with _graph_lock:
        for h in held:
            # taking `name` while holding `h` wants edge h→name; a
            # recorded path name→…→h means another thread takes them
            # in the opposite order — the classic ABBA deadlock
            path = _path_exists(name, h)
            if path is not None:
                raise LockOrderError(
                    f"lock order cycle: acquiring {name!r} while "
                    f"holding {h!r}, but the existing order is "
                    f"{' -> '.join(path)}")
        for h in held:
            _edges.setdefault(h, set()).add(name)


def locked(name: str):
    # held bookkeeping is UNCONDITIONAL: gating it on _enabled would
    # leak a name when lockdep is toggled while a mutex is held,
    # producing false "recursive" errors after re-enable
    _held().append(name)


def will_unlock(name: str):
    held = _held()
    if name in held:
        held.remove(name)


class Mutex:
    """A named, lockdep-checked, non-recursive mutex (reference
    ``ceph::mutex``).  Context-managed like threading.Lock."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, timeout: float | None = None) -> bool:
        will_lock(self.name)
        got = self._lock.acquire(
            timeout=timeout if timeout is not None else -1)
        if got:
            locked(self.name)
        return got

    def release(self):
        will_unlock(self.name)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked_by_me(self) -> bool:
        return self.name in _held()
