"""Runtime lock-order witness (DESIGN.md §12, layer 2).

A lockdep-style drop-in wrapper around ``threading.Lock``/``RLock``:
every lock carries a *class* from the declared rank table
(:mod:`repro.analysis.ranks`), each thread keeps its held-stack in
``threading.local``, and every acquire is checked against the ranks of
the locks already held — strictly increasing order, reentrancy on the
same object allowed, leaf classes terminal, sanctioned inversions from
``ALLOWED_EDGES`` suppressed. Independently of the per-acquire check,
the witness accumulates the *observed* acquisition-order graph (class →
class edges, including sanctioned ones) so cycle detection at teardown
reports potential deadlocks that never manifested in the interleavings
a run happened to see.

Construction sites call :func:`make_lock` / :func:`make_rlock`. With
``REPRO_LOCK_WITNESS`` unset (the default) these return plain
``threading`` primitives — zero steady-state overhead, decided once at
import. With ``REPRO_LOCK_WITNESS=1`` they return witnessed locks in
*record* mode: violations are recorded (not raised) and a session-scoped
conftest fixture fails the run if any were seen, so one bad
interleaving cannot crash mid-test and mask the report. With
``REPRO_LOCK_WITNESS=strict`` a violation raises
:class:`LockOrderViolation` at the acquire site (before blocking on the
inner lock).

``REPRO_LOCK_GRAPH=<path>`` makes the conftest fixture dump the full
observed graph + report as JSON (the nightly CI artifact).
"""

from __future__ import annotations

import json
import os
import threading
import time

from repro_torch.analysis.ranks import ALLOWED_EDGES, LEAF, RANKS

_MODE = os.environ.get("REPRO_LOCK_WITNESS", "")
ENABLED = _MODE not in ("", "0")
STRICT = _MODE == "strict"

# report only the first N distinct violations / long holds — a broken
# hierarchy hits the same site millions of times in a tight loop
_MAX_RECORDS = 200
# runtime analog of the static sleep-under-lock check: warn (never
# fail) when a lock is held longer than this many seconds
_HOLD_WARN_S = float(os.environ.get("REPRO_LOCK_HOLD_WARN_S", "1.0"))


class LockOrderViolation(RuntimeError):
    """Raised at the acquire site in strict mode."""


class _Held:
    __slots__ = ("lock", "cls", "rank", "name", "reentrant", "t0")

    def __init__(self, lock, cls, rank, name, reentrant, t0):
        self.lock = lock
        self.cls = cls
        self.rank = rank
        self.name = name
        self.reentrant = reentrant
        self.t0 = t0


class Witness:
    """One observation domain: rank assertions + observed-order graph.

    Tests build private instances; production wiring uses the module
    :func:`global_witness` so every lock in the process shares one
    graph.
    """

    def __init__(self, *, strict: bool = STRICT,
                 ranks: dict[str, int] | None = None,
                 leaf: frozenset[str] | None = None,
                 allowed: dict | None = None,
                 hold_warn_s: float = _HOLD_WARN_S):
        self.strict = strict
        self.ranks = dict(RANKS if ranks is None else ranks)
        self.leaf = frozenset(LEAF if leaf is None else leaf)
        self.allowed = dict(ALLOWED_EDGES if allowed is None else allowed)
        self.hold_warn_s = hold_warn_s
        self._mu = threading.Lock()  # guards the shared tallies below
        self._tls = threading.local()
        self.violations: list[dict] = []
        self._vkeys: set[tuple] = set()
        self.edges: dict[tuple[str, str], int] = {}
        self.long_holds: list[dict] = []
        self._held_by_thread: dict[int, list[str]] = {}

    # ------------------------------------------------------------ wiring
    def lock(self, lock_class: str, name: str | None = None) -> "_WitnessLock":
        return _WitnessLock(self, threading.Lock(), lock_class, name)

    def rlock(self, lock_class: str, name: str | None = None) -> "_WitnessLock":
        return _WitnessLock(self, threading.RLock(), lock_class, name)

    def _stack(self) -> list[_Held]:
        try:
            return self._tls.stack
        except AttributeError:
            s: list[_Held] = []
            self._tls.stack = s
            return s

    # ----------------------------------------------------------- checks
    def _on_acquire(self, wlock: "_WitnessLock") -> bool:
        """Rank checks + edge recording BEFORE blocking on the inner
        lock (so strict mode reports instead of deadlocking). Returns
        True if this is a reentrant acquire."""
        stack = self._stack()
        if any(h.lock is wlock for h in stack):
            return True
        cls, rank = wlock.lock_class, wlock.rank
        new_edges = []
        worst = None
        for h in stack:
            if (h.cls, cls) not in self.allowed:
                if h.cls in self.leaf:
                    worst = ("leaf-held", h)
                elif h.cls != cls and rank < h.rank:
                    worst = worst or ("order", h)
                elif h.cls == cls and h.lock is not wlock:
                    # two distinct locks of the same class nested —
                    # self-deadlock fodder unless explicitly sanctioned
                    worst = worst or ("same-class", h)
            if h.cls != cls:
                new_edges.append((h.cls, cls))
        if new_edges:
            with self._mu:
                for e in new_edges:
                    self.edges[e] = self.edges.get(e, 0) + 1
        if worst is not None:
            kind, h = worst
            self._record_violation(kind, h, wlock)
        return False

    def _record_violation(self, kind: str, held: _Held,
                          wlock: "_WitnessLock") -> None:
        key = (kind, held.cls, wlock.lock_class)
        msg = (f"{kind}: acquiring {wlock.lock_class!r} "
               f"(rank {wlock.rank}, {wlock.name}) while holding "
               f"{held.cls!r} (rank {held.rank}, {held.name})")
        with self._mu:
            if key not in self._vkeys:
                self._vkeys.add(key)
                if len(self.violations) < _MAX_RECORDS:
                    self.violations.append({
                        "kind": kind,
                        "held": held.cls,
                        "acquired": wlock.lock_class,
                        "thread": threading.current_thread().name,
                        "detail": msg,
                    })
        if self.strict:
            raise LockOrderViolation(msg)

    def _did_acquire(self, wlock: "_WitnessLock", reentrant: bool) -> None:
        self._stack().append(_Held(
            wlock, wlock.lock_class, wlock.rank, wlock.name, reentrant,
            time.monotonic()))
        if not reentrant:
            with self._mu:
                self._held_by_thread.setdefault(
                    threading.get_ident(), []).append(wlock.name)

    def _on_release(self, wlock: "_WitnessLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].lock is wlock:
                h = stack.pop(i)
                if not h.reentrant:
                    dur = time.monotonic() - h.t0
                    with self._mu:
                        held = self._held_by_thread.get(
                            threading.get_ident(), [])
                        if h.name in held:
                            held.remove(h.name)
                        if dur > self.hold_warn_s and \
                                len(self.long_holds) < _MAX_RECORDS:
                            self.long_holds.append({
                                "lock": h.name, "class": h.cls,
                                "seconds": round(dur, 3),
                                "thread":
                                    threading.current_thread().name,
                            })
                return
        # release without a matching tracked acquire: the runtime analog
        # of the static unbalanced-acquire finding
        with self._mu:
            key = ("unbalanced-release", wlock.lock_class, wlock.name)
            if key not in self._vkeys:
                self._vkeys.add(key)
                if len(self.violations) < _MAX_RECORDS:
                    self.violations.append({
                        "kind": "unbalanced-release",
                        "held": None,
                        "acquired": wlock.lock_class,
                        "thread": threading.current_thread().name,
                        "detail": f"release of {wlock.name} with no "
                                  f"tracked acquire on this thread",
                    })

    # ---------------------------------------------------------- teardown
    def cycles(self) -> list[list[str]]:
        """Elementary cycles in the observed class graph (including
        sanctioned edges: an ALLOWED_EDGES exemption plus a later
        reverse edge is exactly the deadlock the exemption argued could
        not happen)."""
        adj: dict[str, list[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        out: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()

        def dfs(node: str, path: list[str], on_path: set[str],
                done: set[str]) -> None:
            on_path.add(node)
            path.append(node)
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    canon = tuple(sorted(cyc[:-1]))
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(cyc)
                elif nxt not in done:
                    dfs(nxt, path, on_path, done)
            on_path.discard(node)
            path.pop()
            done.add(node)

        done: set[str] = set()
        for node in sorted(adj):
            if node not in done:
                dfs(node, [], set(), done)
        return out

    def held_at_teardown(self) -> dict[str, list[str]]:
        """Locks still held per live thread — leaked daemons show here."""
        with self._mu:
            live = {t.ident: t.name for t in threading.enumerate()}
            return {
                live[tid]: list(names)
                for tid, names in self._held_by_thread.items()
                if names and tid in live
            }

    def report(self) -> dict:
        with self._mu:
            edges = {f"{a}->{b}": n for (a, b), n in sorted(self.edges.items())}
            violations = list(self.violations)
            long_holds = list(self.long_holds)
        return {
            "enabled": True,
            "strict": self.strict,
            "violations": violations,
            "edges": edges,
            "cycles": self.cycles(),
            "held_at_teardown": self.held_at_teardown(),
            "long_holds": long_holds,
            "ranks": dict(self.ranks),
            "allowed_edges": [f"{a}->{b}" for a, b in sorted(self.allowed)],
        }

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.report(), fh, indent=2, sort_keys=True)


class _WitnessLock:
    """Drop-in for ``threading.Lock``/``RLock`` under a witness."""

    __slots__ = ("_witness", "_inner", "lock_class", "rank", "name")

    def __init__(self, witness: Witness, inner, lock_class: str,
                 name: str | None):
        if lock_class not in witness.ranks:
            raise ValueError(f"unknown lock class {lock_class!r} — add it "
                             f"to repro.analysis.ranks.RANKS")
        self._witness = witness
        self._inner = inner
        self.lock_class = lock_class
        self.rank = witness.ranks[lock_class]
        self.name = name or f"{lock_class}@{id(self):x}"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentrant = self._witness._on_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness._did_acquire(self, reentrant)
        return ok

    def release(self) -> None:
        self._witness._on_release(self)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<WitnessLock {self.name} rank={self.rank}>"


_global: Witness | None = None
_global_mu = threading.Lock()


def global_witness() -> Witness:
    """The process-wide witness (created on first use)."""
    global _global
    with _global_mu:
        if _global is None:
            _global = Witness()
        return _global


def make_lock(lock_class: str, name: str | None = None):
    """A ``threading.Lock`` — witnessed iff REPRO_LOCK_WITNESS is set."""
    if not ENABLED:
        return threading.Lock()
    return global_witness().lock(lock_class, name)


def make_rlock(lock_class: str, name: str | None = None):
    """A ``threading.RLock`` — witnessed iff REPRO_LOCK_WITNESS is set."""
    if not ENABLED:
        return threading.RLock()
    return global_witness().rlock(lock_class, name)
