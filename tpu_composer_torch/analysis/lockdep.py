"""lockdep: a runtime lock-acquisition-order witness for ObservedLock
(port of ``tpu_composer/analysis/lockdep.py``).

Every ``ObservedLock`` acquire/release (runtime/contention.py) feeds a
per-thread held-lock stack, and each "acquire B while holding A"
observation adds the edge A→B to a global acquisition-order graph. Lock
ORDER must be globally consistent — the first B→A observation that
closes a cycle is a potential ABBA deadlock (for example admission hooks
holding the Store lock reading through the informer cache, while a lazy
informer start holding the cache lock lists through the store) even if
the two threads never actually collided in this run, and the witness
reports it with both acquisition stacks.

Semantics (mirroring the kernel's lockdep where it translates):

- **Lock classes, not instances.** Edges are keyed by lock NAME (the
  ObservedLock name = the lock's class: ``store``, ``informer:<kind>``,
  ``dispatcher``, ...). Two Store instances in a two-replica test share
  the class ``store``.
- **Same-class nesting is not a cycle.** Holding instance A of class
  ``store`` while acquiring instance B of the same class would render as
  a self-edge; without subclass annotations that is noise (the
  two-replica harnesses do this legitimately), so self-edges are counted
  (``nested_same_class``) but never treated as cycles. A DIFFERENT pair
  of classes closing a loop always is.
- **Cond-parks release.** ``Condition.wait`` really releases the lock:
  ``_release_save`` pops it from the held stack, ``_acquire_restore``
  re-pushes WITHOUT recording edges — the order was established at the
  original acquire, and a wakeup re-acquire is not a new ordering
  decision.
- **Reentrancy is free.** Only the outermost acquire of an RLock is an
  ordering event; contention.py already filters inner re-acquires.
- **Declared order.** ``declare_order(earlier, later)`` pins an edge
  direction a priori (the store/informer order below); a later observation of the REVERSED edge raises
  immediately even before any cycle exists.

Modes: the witness raises :class:`LockOrderViolation` at the offending
acquire when ``strict`` (the test-suite default — the stack that closed
the cycle is the bug's address), or records the report for teardown when
not. Either way every cycle lands in ``reports`` for the session
summary and the ``TPUC_LOCKDEP_FILE`` artifact.

Enabled via ``TPUC_LOCKDEP=1`` (the port's operator twins enable it
strict); the disabled path costs ObservedLock one module-global
``is None`` check per outermost acquire.
"""

from __future__ import annotations

import json
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple


class LockOrderViolation(RuntimeError):
    """Raised (strict mode) at the acquire that closed an order cycle or
    contradicted a declared order."""


class _Edge:
    """First-observation evidence for one ordered pair (a held while b
    acquired)."""

    __slots__ = ("held", "acquired", "thread", "stack", "count")

    def __init__(self, held: str, acquired: str, thread: str, stack: str) -> None:
        self.held = held
        self.acquired = acquired
        self.thread = thread
        self.stack = stack
        self.count = 1

    def summary(self) -> Dict[str, object]:
        return {
            "held": self.held,
            "acquired": self.acquired,
            "thread": self.thread,
            "count": self.count,
            "stack": self.stack,
        }


class LockdepWitness:
    """One acquisition-order graph. The module-level singleton is what
    ObservedLock feeds; standalone instances back the unit tests and the
    ABBA regression fixture (so a deliberately-poisoned graph never
    leaks into the suite-wide witness)."""

    def __init__(self, strict: bool = True, stack_depth: int = 12) -> None:
        self.strict = strict
        self.stack_depth = stack_depth
        self._lock = threading.Lock()
        #: adjacency: held-class -> {acquired-class}
        self._succ: Dict[str, Set[str]] = {}
        self._edges: Dict[Tuple[str, str], _Edge] = {}
        self._declared: List[Tuple[str, str]] = []  # (earlier, later)
        # Lock classes seen at ANY acquire (not just edge-forming ones) so
        # /debug/lockdep shows coverage on an idle operator. A dict with
        # GIL-atomic setitem: the hot no-locks-held acquire path must not
        # take the witness lock.
        self._classes: Dict[str, bool] = {}
        self._reported: Set[Tuple[str, str]] = set()  # deduped closing edges
        self.nested_same_class = 0
        self.reports: List[Dict[str, object]] = []

    # -- declared order ------------------------------------------------
    def declare_order(self, earlier: str, later: str) -> None:
        """Pin ``earlier`` strictly before ``later``: observing ``later``
        held while ``earlier`` is acquired is a violation on first sight,
        cycle or not. A trailing ``*`` matches a class-name prefix
        (``informer:*`` covers every per-kind informer lock)."""
        with self._lock:
            self._declared.append((earlier, later))

    @staticmethod
    def _match(pattern: str, name: str) -> bool:
        if pattern.endswith("*"):
            return name.startswith(pattern[:-1])
        return name == pattern

    def _declared_forbids(self, held: str, acquiring: str) -> Optional[str]:
        """Non-None (the declaration text) when acquiring ``acquiring``
        while holding ``held`` contradicts a declared order."""
        for earlier, later in self._declared:
            if self._match(earlier, acquiring) and self._match(later, held):
                return f"{earlier} strictly before {later}"
        return None

    # -- hot-path hooks (called by ObservedLock) -----------------------
    def held_stack(self) -> List[Tuple[str, int]]:
        """The held stack is MODULE-global, not per-witness: which locks
        a thread physically holds is process truth. If each witness kept
        its own, a scoped_witness swap while a background thread held an
        ObservedLock would strand the push in the old witness (the
        release inside the scope pops the new one), and the stale entry
        would fabricate edges — spurious strict violations in unrelated
        later tests."""
        stack = getattr(_held_tls, "held", None)
        if stack is None:
            stack = _held_tls.held = []
        return stack

    def note_acquire(self, name: str, instance_id: int) -> None:
        """Record ordering edges for acquiring ``name`` while holding the
        current stack. Called BEFORE blocking on the inner lock: the
        ordering decision is made at the attempt, and recording it even
        for uncontended acquires is what lets the witness flag a cycle no
        actual collision exercised."""
        self._classes[name] = True  # GIL-atomic; no witness lock needed
        held = self.held_stack()
        if held:
            self._observe(held, name, instance_id)
        held.append((name, instance_id))

    def note_acquire_failed(self, name: str) -> None:
        """A non-blocking/timed acquire failed: undo the speculative
        push (edges stay — the ordering ATTEMPT happened)."""
        held = self.held_stack()
        if held and held[-1][0] == name:
            held.pop()

    def note_release(self, name: str) -> None:
        held = self.held_stack()
        # Out-of-order releases are legal (lock A then B, release A then
        # B): remove the most recent matching entry.
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                del held[i]
                return

    def note_park(self, name: str) -> None:
        """Condition.wait released the lock for the park's duration."""
        self.note_release(name)

    def note_unpark(self, name: str, instance_id: int) -> None:
        """Wakeup re-acquired the cond lock. Deliberately NOT an ordering
        event (see module docstring) — just restore the held stack."""
        self.held_stack().append((name, instance_id))

    # -- graph ---------------------------------------------------------
    def _observe(
        self, held: List[Tuple[str, int]], name: str, instance_id: int
    ) -> None:
        thread = threading.current_thread().name
        new_reports = []
        with self._lock:
            for held_name, held_id in held:
                if held_name == name:
                    if held_id != instance_id:
                        self.nested_same_class += 1
                    continue  # same-class nesting: counted, never a cycle
                key = (held_name, name)
                edge = self._edges.get(key)
                if edge is not None:
                    edge.count += 1
                    continue
                if key in self._reported:
                    continue  # this bad edge already produced a report
                stack = "".join(
                    traceback.format_stack(limit=self.stack_depth)[:-2]
                )
                declared = self._declared_forbids(held_name, name)
                if declared is not None:
                    report = self._declared_violation_report(
                        held_name, name, declared, thread, stack
                    )
                    self._reported.add(key)
                    self.reports.append(report)
                    new_reports.append(report)
                    continue  # don't poison the graph with the bad edge
                path = self._path(name, held_name)
                if path is not None:
                    report = self._cycle_report(
                        held_name, name, path, thread, stack
                    )
                    self._reported.add(key)
                    self.reports.append(report)
                    new_reports.append(report)
                    continue  # keep the graph acyclic: reject the edge
                self._edges[key] = _Edge(held_name, name, thread, stack)
                self._succ.setdefault(held_name, set()).add(name)
        if new_reports and self.strict:
            raise LockOrderViolation(format_report(new_reports[0]))

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src -> ... -> dst in the order graph, or None."""
        if src == dst:
            return [src]
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            for nxt in self._succ.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _cycle_report(
        self,
        held: str,
        acquired: str,
        path: List[str],
        thread: str,
        stack: str,
    ) -> Dict[str, object]:
        # path runs acquired -> ... -> held through existing edges; the
        # new held->acquired edge closes the loop back to the start.
        cycle = path + [acquired]
        evidence = []
        for a, b in zip(path, path[1:]):
            edge = self._edges.get((a, b))
            if edge is not None:
                evidence.append(edge.summary())
        return {
            "kind": "cycle",
            "closing_edge": {"held": held, "acquired": acquired},
            "cycle": cycle,
            "thread": thread,
            "stack": stack,
            "evidence": evidence,
        }

    def _declared_violation_report(
        self, held: str, acquired: str, declared: str, thread: str, stack: str
    ) -> Dict[str, object]:
        return {
            "kind": "declared-order",
            "closing_edge": {"held": held, "acquired": acquired},
            "declared": declared,
            "thread": thread,
            "stack": stack,
            "evidence": [],
        }

    # -- reporting -----------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "classes": sorted(list(self._classes)),
                "edges": [e.summary() for e in self._edges.values()],
                "declared": [
                    {"earlier": a, "later": b} for a, b in self._declared
                ],
                "nested_same_class": self.nested_same_class,
                "reports": list(self.reports),
            }

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)


def format_report(report: Dict[str, object]) -> str:
    edge = report["closing_edge"]
    if report["kind"] == "declared-order":
        head = (
            f"lockdep: declared-order violation — acquired"
            f" '{edge['acquired']}' while holding '{edge['held']}'"
            f" (declared: {report['declared']})"
        )
    else:
        head = (
            "lockdep: potential ABBA deadlock — acquiring"
            f" '{edge['acquired']}' while holding '{edge['held']}' closes"
            f" the cycle {' -> '.join(report['cycle'])}"
        )
    lines = [head, f"  offending thread: {report['thread']}"]
    stack = str(report.get("stack", "")).rstrip()
    if stack:
        lines.append("  acquisition stack:")
        lines.extend("    " + ln for ln in stack.splitlines())
    for ev in report.get("evidence", []):
        lines.append(
            f"  prior edge {ev['held']} -> {ev['acquired']} first seen on"
            f" thread {ev['thread']} (x{ev['count']}):"
        )
        lines.extend(
            "    " + ln for ln in str(ev["stack"]).rstrip().splitlines()
        )
    return "\n".join(lines)


# -- module-level witness (what ObservedLock feeds) ----------------------

#: Per-thread held-lock stacks — shared by every witness (see
#: LockdepWitness.held_stack for why).
_held_tls = threading.local()

_witness: Optional[LockdepWitness] = None
_witness_lock = threading.Lock()


def enable(strict: bool = True) -> LockdepWitness:
    """Install (or return) the process-wide witness. Idempotent; the
    strict flag of the FIRST enable wins for an existing witness."""
    global _witness
    with _witness_lock:
        if _witness is None:
            _witness = LockdepWitness(strict=strict)
            _declare_default_order(_witness)
        return _witness


def disable() -> None:
    global _witness
    with _witness_lock:
        _witness = None


def current() -> Optional[LockdepWitness]:
    return _witness


class scoped_witness:
    """Swap in a fresh witness for a ``with`` block — the ABBA regression
    fixture deliberately poisons its graph, which must never leak into
    the suite-wide one."""

    def __init__(self, strict: bool = True) -> None:
        self.witness = LockdepWitness(strict=strict)
        self._prev: Optional[LockdepWitness] = None

    def __enter__(self) -> LockdepWitness:
        global _witness
        with _witness_lock:
            self._prev = _witness
            _witness = self.witness
        return self.witness

    def __exit__(self, *exc) -> None:
        global _witness
        with _witness_lock:
            _witness = self._prev


def dump_file() -> None:
    """Env-gated artifact write (``$TPUC_LOCKDEP_FILE``) for the
    crash/black-box hooks and a test session's teardown; no-op without an
    active witness or a configured path. Never raises (callers are exit
    paths)."""
    import os

    path = os.environ.get("TPUC_LOCKDEP_FILE", "")
    w = _witness
    if not path or w is None:
        return
    try:
        w.dump(path)
    except OSError:
        pass


def _declare_default_order(w: LockdepWitness) -> None:
    """The one order the repo has already paid to learn (an ABBA
    between admission hooks and a lazy informer start): informer locks nest INSIDE the store lock — the store's
    admission hooks may read through the cache, so an informer lock must
    never be held while the store lock is acquired. Declared for every
    informer class the cache constructs (names are per-kind)."""
    w.declare_order("store", "informer:*")
