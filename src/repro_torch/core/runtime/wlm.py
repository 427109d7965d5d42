"""Workload manager (paper §5.2).

Administers access to LLAP resources through *resource plans*: pools with
capacity fractions and admission parallelism, mappings that route queries to
pools by user/application, and triggers that move or kill queries based on
runtime metrics.  Only one plan is active at a time; plans persist in the
metastore.  Idle pool capacity may be borrowed by queries from other pools
until the owning pool claims it.

Admission has two entry points: :meth:`WorkloadManager.admit` (admit or
raise — the synchronous execution path) and
:meth:`WorkloadManager.wait_admit` (queue until a running query releases
pool capacity — the async scheduler's path, woken by
:meth:`WorkloadManager.release` and responsive to the handle's
``CancelToken`` while queued).

Admission state is **sharded per pool** (lock striping): every pool keeps
its own condition variable and FIFO queue, so hundreds of concurrent
``execute_async`` handles queued on different pools don't convoy behind
one global condvar.  The small amount of cross-pool state — slot table,
pool load counters, borrow rotation — lives under a separate short-hold
lock (``_lock``); the ordering discipline is shard lock first, then
``_lock``, and :meth:`release` notifies shards only after dropping
``_lock``, so the two layers never deadlock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from ...analysis.lockdep import make_condition, make_lock, make_rlock
from ..metastore import Metastore
from ..obs.metrics import MetricsRegistry


class QueryKilledError(Exception):
    pass


@dataclass
class PoolDef:
    name: str
    alloc_fraction: float
    query_parallelism: int


@dataclass
class RuleDef:
    name: str
    metric: str  # e.g. total_runtime (ms), rows_produced
    threshold: float
    action: str  # 'move' | 'kill'
    target_pool: Optional[str] = None
    pools: List[str] = field(default_factory=list)  # pools the rule is attached to


@dataclass
class ResourcePlan:
    name: str
    pools: Dict[str, PoolDef] = field(default_factory=dict)
    rules: Dict[str, RuleDef] = field(default_factory=dict)
    mappings: List[tuple] = field(default_factory=list)  # (kind, entity, pool)
    default_pool: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "pools": {
                k: {"alloc_fraction": p.alloc_fraction,
                    "query_parallelism": p.query_parallelism}
                for k, p in self.pools.items()
            },
            "rules": {
                k: {"metric": r.metric, "threshold": r.threshold,
                    "action": r.action, "target_pool": r.target_pool,
                    "pools": r.pools}
                for k, r in self.rules.items()
            },
            "mappings": self.mappings,
            "default_pool": self.default_pool,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ResourcePlan":
        plan = cls(d["name"])
        for k, p in d.get("pools", {}).items():
            plan.pools[k] = PoolDef(k, p["alloc_fraction"], p["query_parallelism"])
        for k, r in d.get("rules", {}).items():
            plan.rules[k] = RuleDef(k, r["metric"], r["threshold"], r["action"],
                                    r.get("target_pool"), list(r.get("pools", [])))
        plan.mappings = [tuple(m) for m in d.get("mappings", [])]
        plan.default_pool = d.get("default_pool")
        return plan


@dataclass
class QuerySlot:
    query_id: str
    pool: str
    admitted_at: float = field(default_factory=time.time)
    borrowed_from: Optional[str] = None
    metrics: Dict[str, float] = field(default_factory=dict)
    killed: bool = False
    moves: List[str] = field(default_factory=list)
    cancel_token: Optional[object] = None  # CancelToken of an async handle


class _PoolShard:
    """Per-pool admission stripe: its own condvar + FIFO ticket queue."""

    __slots__ = ("lock", "cond", "waiting")

    def __init__(self):
        self.lock = make_rlock("wlm.shard")
        self.cond = make_condition(self.lock, name="wlm.shard.cond")
        self.waiting: Deque[object] = deque()


class WorkloadManager:
    def __init__(self, hms: Metastore, total_executors: int = 16,
                 metrics: Optional[MetricsRegistry] = None):
        self.hms = hms
        self.total_executors = total_executors
        # admission counters live in the warehouse MetricsRegistry (PR 10);
        # a private registry keeps directly-constructed managers working
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.gauge("wlm.queue_depths", self.queue_depths)
        # cross-pool state: slot table, load counters, borrow rotation.
        # Held briefly; never while waiting.  Lock order: shard then _lock.
        self._lock = make_rlock("wlm.global")
        self._active: Optional[ResourcePlan] = None
        self._running: Dict[str, QuerySlot] = {}
        self._pool_load: Dict[str, int] = {}
        # per-pool admission shards (fair FIFO queueing; see wait_admit)
        self._shards: Dict[Optional[str], _PoolShard] = {}
        self._shards_lock = make_lock("wlm.shards")
        # round-robin rotation among pool heads contending for borrowed
        # idle capacity: the pool that borrowed last yields to the next
        # contending pool in cyclic (sorted-name) order
        self._borrow_last: Optional[str] = None
        plan_dict = hms.active_resource_plan()
        if plan_dict:
            self._active = ResourcePlan.from_dict(plan_dict)
            self._pool_load = {p: 0 for p in self._active.pools}

    def _shard(self, pool: Optional[str]) -> _PoolShard:
        with self._shards_lock:
            shard = self._shards.get(pool)
            if shard is None:
                shard = self._shards[pool] = _PoolShard()
            return shard

    # ------------------------------------------------------------- plan DDL
    def create_plan(self, name: str) -> None:
        self.hms.save_resource_plan(name, ResourcePlan(name).to_dict())

    def _load(self, name: str) -> ResourcePlan:
        d = self.hms.get_resource_plan(name)
        if d is None:
            raise KeyError(f"no resource plan {name}")
        return ResourcePlan.from_dict(d)

    def _store(self, plan: ResourcePlan) -> None:
        self.hms.save_resource_plan(plan.name, plan.to_dict())
        if self._active and self._active.name == plan.name:
            self._active = plan
            for p in plan.pools:
                self._pool_load.setdefault(p, 0)

    def create_pool(self, plan_name: str, pool: str, alloc_fraction: float,
                    query_parallelism: int) -> None:
        plan = self._load(plan_name)
        plan.pools[pool] = PoolDef(pool, alloc_fraction, query_parallelism)
        self._store(plan)

    def create_rule(self, plan_name: str, rule: str, metric: str,
                    threshold: float, action: str,
                    target_pool: Optional[str]) -> None:
        plan = self._load(plan_name)
        plan.rules[rule] = RuleDef(rule, metric, threshold, action, target_pool)
        self._store(plan)

    def add_rule_to_pool(self, plan_name: str, rule: str, pool: str) -> None:
        plan = self._load(plan_name)
        plan.rules[rule].pools.append(pool)
        self._store(plan)

    def create_mapping(self, plan_name: str, kind: str, entity: str, pool: str) -> None:
        plan = self._load(plan_name)
        plan.mappings.append((kind, entity, pool))
        self._store(plan)

    def set_default_pool(self, plan_name: str, pool: str) -> None:
        plan = self._load(plan_name)
        plan.default_pool = pool
        self._store(plan)

    def activate(self, plan_name: str) -> None:
        plan = self._load(plan_name)
        self.hms.activate_resource_plan(plan_name)
        with self._lock:
            self._active = plan
            self._pool_load = {p: 0 for p in plan.pools}

    @property
    def active_plan(self) -> Optional[ResourcePlan]:
        return self._active

    # ------------------------------------------------------------- admission
    def route(self, user: Optional[str] = None, application: Optional[str] = None) -> Optional[str]:
        plan = self._active
        if plan is None:
            return None
        for kind, entity, pool in plan.mappings:
            if kind == "application" and application == entity:
                return pool
            if kind == "user" and user == entity:
                return pool
        return plan.default_pool or (next(iter(plan.pools)) if plan.pools else None)

    def admit(self, query_id: str, user=None, application=None,
              cancel_token=None) -> Optional[QuerySlot]:
        """Admit or die: raises :class:`QueryKilledError` when the routed
        pool is saturated and no idle capacity can be borrowed (the
        pre-async behavior, kept for the synchronous execution path)."""
        slot, saturated = self.try_admit(query_id, user, application,
                                         cancel_token)
        if saturated:
            pool = self.route(user, application)
            raise QueryKilledError(
                f"pool {pool} at parallelism limit and no idle capacity"
            )
        return slot

    def try_admit(self, query_id: str, user=None, application=None,
                  cancel_token=None):
        """Non-blocking admission probe.

        Returns ``(slot, saturated)``: ``(QuerySlot, False)`` on admission,
        ``(None, False)`` when no resource plan applies (run unmanaged), and
        ``(None, True)`` when the routed pool is at its parallelism limit
        with no idle capacity to borrow — the caller may queue and retry.
        """
        with self._lock:
            plan = self._active
            if plan is None:
                return None, False
            pool = self.route(user, application)
            if pool is None:
                return None, False
            slot = QuerySlot(query_id, pool, cancel_token=cancel_token)
            if self._pool_load.get(pool, 0) >= plan.pools[pool].query_parallelism:
                # pool saturated: borrow idle capacity from another pool
                # (§5.2).  When several pools' queue heads contend for the
                # same idle capacity, grants rotate round-robin across the
                # contending pools instead of going to whichever head woke
                # first.
                if not self._borrow_turn(pool):
                    return None, True
                for other, pdef in plan.pools.items():
                    if other != pool and self._pool_load.get(other, 0) < pdef.query_parallelism:
                        slot.borrowed_from = other
                        pool_to_charge = other
                        self._borrow_last = pool
                        break
                else:
                    return None, True
            else:
                pool_to_charge = pool
            self._pool_load[pool_to_charge] = self._pool_load.get(pool_to_charge, 0) + 1
            slot.metrics["charged_pool"] = pool_to_charge
            self._running[query_id] = slot
            self.metrics.inc("wlm.admitted")
            if slot.borrowed_from is not None:
                self.metrics.inc("wlm.borrowed")
            return slot, False

    def _borrow_turn(self, pool: str) -> bool:
        """May ``pool``'s queue head borrow idle capacity right now?

        With zero or one pool queueing there is no contention and any
        borrower may proceed.  With several, the grant rotates cyclically
        (sorted pool order) starting after the pool that borrowed last —
        arrival at the shared condition variable no longer decides."""
        # len() of another shard's deque is read without its lock — the
        # rotation is a fairness heuristic, and a stale length only shifts
        # whose turn it is by one grant
        with self._shards_lock:
            shards = list(self._shards.items())
        contenders = sorted(p for p, s in shards
                            if p is not None and s.waiting)
        if len(contenders) <= 1 or pool not in contenders:
            return True
        last = self._borrow_last
        if last is None:
            allowed = contenders[0]
        else:
            after = [p for p in contenders if p > last]
            allowed = after[0] if after else contenders[0]
        return pool == allowed

    def wait_admit(self, query_id: str, user=None, application=None,
                   cancel_token=None, timeout: Optional[float] = None,
                   poll_interval: float = 0.05) -> Optional[QuerySlot]:
        """Blocking admission through per-pool FIFO queues.

        Each routed pool keeps its own queue and only the queue *head* may
        probe for capacity, so admission within a pool is arrival-ordered
        instead of FIFO-by-wakeup (a late waiter can no longer race an
        earlier one to a freed slot); the per-pool heads round-robin over
        borrowable idle capacity via the shared condition variable.
        Re-probes whenever a running query releases capacity (and at
        ``poll_interval`` so a tripped ``cancel_token`` is observed
        promptly).  Raises the token's error when cancelled/killed while
        queued, and :class:`QueryKilledError` on ``timeout``.
        """
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        ticket = object()
        pool = self.route(user, application)
        shard = self._shard(pool)
        with shard.cond:
            if cancel_token is not None:
                cancel_token.check()
            # fast path only when nobody is queued for the routed pool —
            # otherwise a new arrival could race the queue head to a slot
            # that was freed between the release and the head's wakeup
            if not shard.waiting:
                slot, saturated = self.try_admit(query_id, user, application,
                                                 cancel_token)
                if not saturated:
                    return slot
            shard.waiting.append(ticket)
            try:
                while True:
                    if cancel_token is not None:
                        cancel_token.check()
                    if shard.waiting[0] is ticket:
                        slot, saturated = self.try_admit(
                            query_id, user, application, cancel_token)
                        if not saturated:
                            return slot
                    wait = poll_interval
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            self.metrics.inc("wlm.admission_timeouts")
                            raise QueryKilledError(
                                f"query {query_id} timed out waiting for "
                                f"admission"
                            )
                        wait = min(wait, remaining)
                    shard.cond.wait(wait)
            finally:
                try:
                    shard.waiting.remove(ticket)
                except ValueError:  # pragma: no cover - defensive
                    pass
                # the next-in-line head (if any) probes immediately
                shard.cond.notify_all()

    def queue_depths(self) -> Dict[str, int]:
        """Admission queue depth per pool (for ``QueryHandle.poll()``
        diagnostics: which pools have unplaceable queries right now)."""
        with self._shards_lock:
            shards = list(self._shards.items())
        out = {p: 0 for p in (self._active.pools if self._active else ())}
        out.update({p: len(s.waiting) for p, s in shards
                    if p is not None and s.waiting})
        return out

    def executors_for(self, slot: Optional[QuerySlot]) -> int:
        if slot is None or self._active is None:
            return self.total_executors
        frac = self._active.pools[slot.pool].alloc_fraction
        return max(1, int(self.total_executors * frac))

    # ------------------------------------------------------------- triggers
    def update_metrics(self, query_id: str, **metrics) -> None:
        """Record metrics and fire any matching triggers (move/kill)."""
        with self._lock:
            slot = self._running.get(query_id)
            plan = self._active
            if slot is None or plan is None:
                return
            slot.metrics.update(metrics)
            slot.metrics["total_runtime"] = (time.time() - slot.admitted_at) * 1000.0
            for rule in plan.rules.values():
                if rule.pools and slot.pool not in rule.pools:
                    continue
                value = slot.metrics.get(rule.metric)
                if value is None or value <= rule.threshold:
                    continue
                if rule.action == "move" and rule.target_pool and slot.pool != rule.target_pool:
                    slot.moves.append(f"{slot.pool}->{rule.target_pool}")
                    slot.pool = rule.target_pool
                    self.metrics.inc("wlm.moved")
                elif rule.action == "kill":
                    slot.killed = True
                    self.metrics.inc("wlm.killed")
        if slot.killed:
            # trip the handle's token first so sibling DAG vertices stop at
            # their next boundary, then surface the kill to the caller
            if slot.cancel_token is not None:
                slot.cancel_token.kill(
                    f"query {query_id} killed by trigger"
                )
            raise QueryKilledError(f"query {query_id} killed by trigger")

    def release(self, query_id: str) -> None:
        with self._lock:
            slot = self._running.pop(query_id, None)
            if slot is not None:
                self.metrics.inc("wlm.released")
                charged = slot.metrics.get("charged_pool", slot.pool)
                if charged in self._pool_load and self._pool_load[charged] > 0:
                    self._pool_load[charged] -= 1
        if slot is None:
            return
        # wake waiters *after* dropping _lock (shard-then-_lock ordering).
        # Freed capacity in one pool can admit another pool's head via
        # borrowing, so every shard with waiters is notified; the shards'
        # 0.05s poll backstop covers any shard created concurrently.
        with self._shards_lock:
            shards = list(self._shards.values())
        for shard in shards:
            with shard.cond:
                if shard.waiting:
                    shard.cond.notify_all()
