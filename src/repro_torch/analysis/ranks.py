"""The machine-checked lock-rank table (DESIGN.md §12).

One declaration shared by both enforcement layers — the static analyzer
(:mod:`repro.analysis.lockcheck`) and the runtime witness
(:mod:`repro.analysis.witness`) — so the hierarchy documented in
DESIGN.md §4/§5 can never drift from what is enforced.

Rule: a thread may only acquire a lock whose rank is **strictly
greater** than every rank it already holds (re-acquiring the *same*
RLock object is reentrancy, always allowed). Leaf classes may be
acquired at any point but nothing may be acquired while holding one.

The DESIGN.md §4/§5 hierarchy ``metadata → partition → controller``
maps onto the coarse ranks ``metadata=0, group/partition=1, log=2,
controller=3, metrics/registry=leaf``; the table below refines each
level with the sub-orderings the code actually relies on (e.g. a
``StreamLog``'s topics lock is acquired before its per-partition locks,
and the controller's *internal* metadata ``StreamLog`` nests inside the
controller lock, so it is a distinct lock class ranked above it).
"""

from __future__ import annotations

# lock class -> rank. Strictly-increasing acquisition order; gaps are
# deliberate so future classes slot in without renumbering.
RANKS: dict[str, int] = {
    # BrokerCluster._txn_locks[pid] — per-pid 2PC phase-two serialization.
    # Documented in cluster.py as "acquired BEFORE the metadata lock,
    # never while holding it", hence the only class below metadata.
    "txn": -10,
    # BrokerCluster._meta_lock — topology / offset store (coarse rank 0).
    "metadata": 0,
    # ConsumerGroup._lock — membership/assignment (coarse rank 1).
    "group": 10,
    # _PartitionCtl.lock / BrokerCluster._data_lock (coarse rank 1).
    "partition": 10,
    # StreamLog._lock — broker-local topics dict (coarse rank 2).
    "log": 20,
    # log._Partition.lock — per-partition segment state (coarse rank 2;
    # StreamLog acquires it while holding its topics lock).
    "log-part": 25,
    # QuorumController._lock (coarse rank 3).
    "controller": 30,
    # A controller NODE's internal metadata StreamLog: appended to while
    # the controller lock is held, so it is a distinct class nested
    # strictly inside "controller" (a broker data log never is).
    "ctl-log": 40,
    "ctl-log-part": 45,
    # LMEngine/ContinuousLMEngine._lock — serving request queue. Guards
    # only deque/slot bookkeeping; polled consumers and the decode loop
    # submit/admit concurrently. Never held across broker calls, so it
    # ranks above every broker class.
    "engine": 80,
    # MetricsRegistry._lock — series maps; snapshot() reads series values
    # (their leaf locks) while holding it, so it ranks just below leaf.
    "metrics-registry": 90,
    # Leaves: Counter/Gauge/Histogram._lock and the model Registry._lock.
    "metrics": 99,
    "registry": 99,
}

# Classes that must be terminal: acquiring ANY lock while holding one of
# these is a violation even if the ranks would allow it.
LEAF: frozenset[str] = frozenset({"metrics", "registry"})

# Sanctioned rank inversions, each with a one-line justification. Both
# layers consult this: the witness suppresses the acquire-time assertion
# for these (held, acquired) class pairs; teardown cycle detection still
# sees the edges, so a future reverse edge turns the exemption into a
# reported cycle.
ALLOWED_EDGES: dict[tuple[str, str], str] = {
    ("group", "metadata"): (
        "offset commits / rebalances resolve cluster state under the "
        "group lock for generation-fencing atomicity; the broker side "
        "never acquires consumer-group locks, so no cycle is possible"
    ),
    ("group", "log"): (
        "same path on a bare StreamLog backend: the log never calls "
        "back into consumer groups"
    ),
}

# Where locks live in the tree: (module basename, class, attribute) ->
# lock class. The static analyzer resolves `with self.X:` through this
# table (falling back to (module, attribute), then to a substring match
# against class names for out-of-tree fixtures); a constructed lock that
# resolves to nothing is itself a finding, so the table cannot rot.
SITE_TABLE: dict[tuple[str, str, str], str] = {
    ("cluster.py", "BrokerCluster", "_meta_lock"): "metadata",
    ("cluster.py", "BrokerCluster", "_data_lock"): "partition",
    ("cluster.py", "BrokerCluster", "_txn_locks"): "txn",
    ("cluster.py", "_PartitionCtl", "lock"): "partition",
    ("log.py", "StreamLog", "_lock"): "log",
    ("log.py", "_Partition", "lock"): "log-part",
    ("controller.py", "QuorumController", "_lock"): "controller",
    ("consumer.py", "ConsumerGroup", "_lock"): "group",
    ("lm_engine.py", "LMEngine", "_lock"): "engine",
    ("lm_engine.py", "ContinuousLMEngine", "_lock"): "engine",
    ("registry.py", "Registry", "_lock"): "registry",
    ("metrics.py", "MetricsRegistry", "_lock"): "metrics-registry",
    ("metrics.py", "Counter", "_lock"): "metrics",
    ("metrics.py", "Gauge", "_lock"): "metrics",
    ("metrics.py", "Histogram", "_lock"): "metrics",
}

# (module basename, attribute) fallback for locks reached through a
# non-self receiver (`ctl.lock`, `part.lock`) whose static type the AST
# pass does not track.
ATTR_TABLE: dict[tuple[str, str], str] = {
    ("cluster.py", "_meta_lock"): "metadata",
    ("cluster.py", "_data_lock"): "partition",
    ("cluster.py", "_txn_locks"): "txn",
    ("cluster.py", "lock"): "partition",
    ("log.py", "_lock"): "log",
    ("log.py", "lock"): "log-part",
    ("controller.py", "_lock"): "controller",
    ("consumer.py", "_lock"): "group",
    ("lm_engine.py", "_lock"): "engine",
    ("registry.py", "_lock"): "registry",
    ("metrics.py", "_lock"): "metrics",
}


def rank_of(lock_class: str) -> int:
    return RANKS[lock_class]


def classify_attr(
    module: str, cls: str | None, attr: str
) -> str | None:
    """Resolve a lock attribute to its class, most-specific key first."""
    if cls is not None:
        hit = SITE_TABLE.get((module, cls, attr))
        if hit is not None:
            return hit
    hit = ATTR_TABLE.get((module, attr))
    if hit is not None:
        return hit
    # out-of-tree modules (seeded test fixtures): a name like
    # `_partition_lock` or `metadata_mu` self-declares its class
    low = attr.lower()
    for name in sorted(RANKS, key=len, reverse=True):
        if name.replace("-", "_") in low:
            return name
    return None
