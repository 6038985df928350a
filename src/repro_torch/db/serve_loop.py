"""Always-on multi-tenant serving loop with admission control.

The port of `repro.db.serve_loop`: pure scheduling over the port's
`QueryServer` / `ShardedQueryServer`, with the reference's semantics
unchanged.

`QueryServer`/`ShardedQueryServer` batch K queries per synchronous
`run()` call; millions of users arrive as a *continuous stream* over
many tables.  `ServeLoop` lifts the `launch/serve.py` queue/batch
pattern into an always-on front door over any number of registered
servers —

  * **request queue**: clients `submit()` (tenant, table, plan,
    deadline) from any thread and receive a ticket; the loop forms
    batches and resolves each ticket to a `Response`;
  * **admission control**: per-tenant queue-depth caps, a total queue
    cap, and optional per-table tenant ACLs — an over-budget or
    unauthorized submission gets an *explicit* REJECTED response
    instead of unbounded queuing (`AdmissionPolicy`);
  * **per-tenant KeySets**: each registered server carries its own
    `KeySet`, so registering one table per tenant (with a `tenants=`
    ACL) gives every tenant its own keys while all tenants share one
    loop, one scheduler, and one set of kernel launch shapes;
  * **two-class deadline-aware scheduling**: requests classify as
    `point` (every filter leaf rides a `SortedIndex`, no order/top-k
    stage) or `bulk` (full scans, joins, sorts); every pump drafts the
    point batch *first* so an indexed lookup never waits behind a
    34k-row scan, and bulk still gets a draft slot each pump, so
    nothing starves.  Requests whose deadline already passed at
    batch-formation time are SHED (never executed); requests completed
    past deadline are answered with `deadline_missed=True`;
  * **pow2 shape bucketing**: drafted batch sizes round down to a
    power of two, so the underlying fused launches cycle through a
    small closed set of shapes (the engine already pads rows/lanes to
    pow2 for the same reason, and `obs.jitwatch` counts every launch
    signature beyond the first at a site as a retrace); per-launch
    working set stays bounded by the `lane_budget` policy the servers
    carry;
  * **fair-share drafting**: within a class, tenants are drained
    round-robin (per-tenant FIFO preserved) and capped at
    `AdmissionPolicy.fair_share` slots per batch when contended, so
    one chatty tenant cannot monopolize a batch;
  * **write ordering**: mutations are admission-order *barriers* per
    table — a query drafts only after every mutation admitted before
    it (on its table) has applied, and a mutation applies only after
    every earlier-admitted query finished, so every query sees exactly
    the writes admitted before it (the two-class reordering happens
    strictly *between* barriers);
  * **fault isolation**: if a drafted batch raises mid-drain, the loop
    retries its requests one by one — the poisoned request alone
    resolves FAILED (with the error string), everyone else's answer is
    recovered, and the loop keeps serving.  (The engine raises before
    per-tenant billing, so obs counters stay reconciled; recovery goes
    through the servers' public `clear_queue()` / `batch_size()` API.)
    A kernel that fails to build or launch raises `RuntimeError` like
    any other fault and resolves its requests FAILED too, as the
    reference isolates a device error: callers that must tell a device
    fault from a bad plan build the kernels before the first pump and
    hold `stats.failed` to the requests they expect to fail.
  * **bounded retention**: only the most recent `max_responses`
    terminal responses (and batch shapes) are retained — older ones
    evict oldest-first, and clients `forget(ticket)` results as they
    consume them — so the always-on stream never grows loop memory
    without bound.

Observability (all no-ops unless `obs.tracing()` is active):
`serve.queue_depth` histogram (depth at every admit and pump),
`serve.queue_wait_s` histogram per class, `serve.rejected` /
`serve.shed` / `serve.deadline_miss` / `serve.failed` per-tenant
counters, and `serve.pump` / `serve.batch` spans around every drain.

The loop is deterministic when driven synchronously: `pump()` runs one
scheduling round, `run_until_idle()` pumps until the queue drains —
both on an injectable `clock` (deadline tests fake time the same way
`launch/elastic.FleetMonitor` does).  `start()`/`stop()` wrap `pump`
in a daemon thread for the always-on mode, optionally heartbeating a
`FleetMonitor` so the elastic scaffolding sees the loop as a live
host.

CUDA streams: the kernels launch on the calling thread's current
stream, and every thread's current stream is the device's default
stream unless it enters a `torch.cuda.stream(...)` context.  The pump
thread and every client thread that encrypts query ciphertexts must stay
on that one default stream — so do not wrap the loop, or a client's
submissions, in a stream context: the pump would then read ciphertexts
another stream may still be writing.  The servers hand back host
results (numpy row ids, masks and join pairs), so a `Response.done_t`
stamped after `server.run()` returns comes after the device finished.

Usage (on the card; `--device cpu` runs the plain path):
  PYTHONPATH=src python -m repro_torch.db.serve_loop --requests 32 \
      --rows 1024
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.db import plan as P

# scheduling classes
POINT = "point"
BULK = "bulk"
WRITE = "write"

# terminal + pending response states
PENDING = "PENDING"
OK = "OK"
FAILED = "FAILED"
REJECTED = "REJECTED"
SHED = "SHED"


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Queue-depth budgets enforced at submit + draft time.

    `tenant_queue_cap` bounds one tenant's pending requests across all
    tables; `total_queue_cap` bounds the whole loop; `fair_share` caps
    how many of one tenant's requests a single batch drafts when other
    tenants are waiting in the same class."""
    tenant_queue_cap: int = 64
    total_queue_cap: int = 4096
    fair_share: int = 4


@dataclasses.dataclass
class Response:
    """Terminal record for one ticket: status, result, and timing.

    `status` is one of OK / FAILED / REJECTED / SHED (or PENDING while
    queued).  `result` holds the engine's native result object
    (`QueryResult`, `JoinResult`, or `MutationResult`) on OK.  All
    timestamps are on the loop's clock."""
    ticket: int
    tenant: str
    table: str
    klass: str
    status: str = PENDING
    result: object = None
    error: str = ""
    deadline: Optional[float] = None
    deadline_missed: bool = False
    submit_t: float = 0.0
    start_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def done(self) -> bool:
        """True once the ticket reached a terminal status."""
        return self.status != PENDING

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Seconds spent queued before batch formation (None if never
        drafted — rejected/shed requests have no start time)."""
        if self.start_t is None:
            return None
        return max(0.0, self.start_t - self.submit_t)

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-terminal seconds (None while PENDING)."""
        if self.done_t is None:
            return None
        return max(0.0, self.done_t - self.submit_t)


@dataclasses.dataclass
class LoopStats:
    """Loop-level totals — the reconciliation targets for the
    per-tenant obs counters (`sum over tenants == these`)."""
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    shed: int = 0
    served: int = 0
    failed: int = 0
    deadline_miss: int = 0
    batches: int = 0
    pumps: int = 0


@dataclasses.dataclass(eq=False)
class _Pending:
    """One admitted, not-yet-drafted request."""
    ticket: int
    tenant: str
    klass: str
    kind: str                    # "query"|"join"|"insert"|"delete"|"update"
    payload: dict
    deadline: Optional[float]
    seq: int


class _Registration:
    """One served table: its server, its tenant ACL, its admit-order
    pending list (mutations act as barriers within it)."""

    def __init__(self, name: str, server, tenants=None):
        self.name = name
        self.server = server
        self.tenants = None if tenants is None else frozenset(tenants)
        self.pending: List[_Pending] = []


class ServeLoop:
    """Always-on admission-controlled front door over query servers.

    Register any mix of `QueryServer` / `ShardedQueryServer` instances
    (each with its own KeySet — one per tenant if desired), then feed a
    continuous request stream through `submit*`; drive with `pump()` /
    `run_until_idle()` synchronously or `start()` a daemon thread.
    See the module docstring for scheduling/admission semantics."""

    def __init__(self, *, policy: Optional[AdmissionPolicy] = None,
                 batch: int = 8, pow2_buckets: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 monitor=None, monitor_host: int = 0,
                 max_responses: int = 65536):
        self.policy = policy or AdmissionPolicy()
        self.batch = int(batch)
        self.pow2_buckets = bool(pow2_buckets)
        self.clock = clock
        # optional launch/elastic.FleetMonitor: each pump heartbeats
        # `monitor_host` with the pump's wall time, so the elastic
        # scaffolding's dead-host/straggler logic watches the loop
        self.monitor = monitor
        self.monitor_host = monitor_host
        # retention bound for the always-on mode: only the most recent
        # `max_responses` TERMINAL responses (and batch shapes) are
        # kept — unread older terminals are evicted oldest-first, so a
        # continuous stream cannot grow loop memory without bound.
        # PENDING responses are never evicted (callers also `forget()`
        # terminals they have consumed to release results eagerly)
        self.max_responses = int(max_responses)
        self.stats = LoopStats()
        self.batch_shapes: List[Tuple[str, str, int]] = []  # (table, klass, size)
        self._regs: Dict[str, _Registration] = {}
        self._responses: Dict[int, Response] = {}
        self._terminal: "collections.deque[int]" = collections.deque()
        self._next_ticket = 0
        self._next_seq = 0
        self._lock = threading.Lock()        # queue + response state
        self._pump_lock = threading.Lock()   # one scheduling round at a time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration ------------------------------------------------------

    def register(self, name: str, server, *, tenants=None) -> None:
        """Serve `server` (a QueryServer or ShardedQueryServer, carrying
        its own KeySet) under table name `name`.  `tenants` restricts
        who may submit to it (None = open) — registering one table per
        tenant with an ACL gives per-tenant keys behind one loop."""
        with self._lock:
            self._regs[name] = _Registration(name, server, tenants)

    def tables(self) -> List[str]:
        """Registered table names, in registration order."""
        return list(self._regs)

    # -- classification ----------------------------------------------------

    def _classify(self, reg: _Registration, query) -> str:
        """`point` iff every filter leaf rides one of the server's
        sorted indexes and there is no order/top-k stage; else `bulk`.
        (Select-all is a full scan; sorts pay bitonic networks.)"""
        plan = P.compile_plan(query)
        q = plan.query
        if q.order_by is not None or q.top_k is not None:
            return BULK
        if not plan.leaves:
            return BULK
        indexes = reg.server.indexes
        if all(leaf.column in indexes for leaf in plan.leaves):
            return POINT
        return BULK

    # -- admission ---------------------------------------------------------

    def _admit_error(self, reg: _Registration, tenant: str) -> str:
        """Reason to reject, or '' to admit (caller holds the lock)."""
        if reg.tenants is not None and tenant not in reg.tenants:
            return f"tenant {tenant!r} not authorized for table {reg.name!r}"
        total = sum(len(r.pending) for r in self._regs.values())
        if total >= self.policy.total_queue_cap:
            return f"loop queue full ({total} pending)"
        depth = sum(1 for r in self._regs.values()
                    for p in r.pending if p.tenant == tenant)
        if depth >= self.policy.tenant_queue_cap:
            return f"tenant {tenant!r} queue full ({depth} pending)"
        return ""

    def _admit(self, tenant: str, table: str, klass: str, kind: str,
               payload: dict, deadline: Optional[float], *,
               reject: str = "") -> int:
        """Create the ticket; enqueue or immediately REJECT.  A
        non-empty `reject` reason rejects unconditionally — the request
        is never enqueued, so no pump can race a draft against the
        rejection."""
        with self._lock:
            reg = self._regs.get(table)
            if reg is None:
                raise KeyError(f"no table {table!r} registered")
            now = self.clock()
            ticket = self._next_ticket
            self._next_ticket += 1
            self.stats.submitted += 1
            resp = Response(ticket=ticket, tenant=tenant, table=table,
                            klass=klass, deadline=deadline, submit_t=now)
            self._responses[ticket] = resp
            reason = reject or self._admit_error(reg, tenant)
            if reason:
                resp.status = REJECTED
                resp.error = reason
                resp.done_t = now
                self.stats.rejected += 1
                self._retire(ticket)
                obs.count("serve.rejected", 1, tenant=tenant)
                return ticket
            seq = self._next_seq
            self._next_seq += 1
            reg.pending.append(_Pending(ticket, tenant, klass, kind,
                                        payload, deadline, seq))
            self.stats.admitted += 1
            obs.observe("serve.queue_depth",
                        sum(len(r.pending) for r in self._regs.values()))
            return ticket

    def _retire(self, ticket: int) -> None:
        """Record a newly-terminal ticket; evict the oldest retained
        terminals (and batch shapes) past `max_responses` (caller holds
        the lock)."""
        self._terminal.append(ticket)
        while len(self._terminal) > self.max_responses:
            self._responses.pop(self._terminal.popleft(), None)
        if len(self.batch_shapes) > self.max_responses:
            del self.batch_shapes[:-self.max_responses]

    # -- submission --------------------------------------------------------

    def submit(self, tenant: str, table: str, query, *,
               deadline: Optional[float] = None,
               klass: Optional[str] = None) -> int:
        """Submit a Query (or bare predicate) for `tenant` against
        `table`; returns a ticket.  `deadline` (loop-clock seconds) is
        shed-or-flag advisory; `klass` overrides auto classification
        ("point"/"bulk"; anything else raises ValueError — an unknown
        class would pend forever, no pump drafts it)."""
        if klass is not None and klass not in (POINT, BULK):
            raise ValueError(
                f"klass must be {POINT!r} or {BULK!r}, got {klass!r}")
        reg = self._regs.get(table)
        if reg is None:
            raise KeyError(f"no table {table!r} registered")
        if isinstance(query, P.Predicate):
            query = P.Query(where=query)
        klass = klass or self._classify(reg, query)
        return self._admit(tenant, table, klass, "query",
                           {"query": query}, deadline)

    def submit_join(self, tenant: str, table: str, join: P.Join, right, *,
                    right_indexes=None, strategy: str = "auto",
                    deadline: Optional[float] = None) -> int:
        """Submit a Join (left side = `table`'s server) — always bulk
        class.  REJECTED with an explanatory error if the server has no
        join support (the sharded server does not, yet)."""
        if not hasattr(self._require(table).server, "submit_join"):
            # rejected inside _admit, atomically: the request is never
            # enqueued, so a concurrent pump cannot draft (and fail) it
            # before the rejection lands
            return self._admit(
                tenant, table, BULK, "join", {}, deadline,
                reject=(f"table {table!r}'s server does not "
                        "support joins"))
        P.compile_join(join)      # validate shape at submit time
        return self._admit(tenant, table, BULK, "join",
                           {"join": join, "right": right,
                            "right_indexes": right_indexes,
                            "strategy": strategy}, deadline)

    def submit_insert(self, tenant: str, table: str, data, seed: int = 0,
                      *, samples=None,
                      deadline: Optional[float] = None) -> int:
        """Submit an insert — write class, an ordering barrier: queries
        admitted after it (on this table) see the new rows.  The rows
        encrypt under `seed` (or from pre-drawn `samples`), forwarded
        unchanged to the server's `submit_insert`.  Writes are never
        shed (shedding one would break read-your-admitted-writes for
        every later query)."""
        return self._admit(tenant, table, WRITE, "insert",
                           {"data": data, "seed": seed,
                            "samples": samples}, deadline)

    def submit_delete(self, tenant: str, table: str, rows, *,
                      deadline: Optional[float] = None) -> int:
        """Submit a tombstone of global row ids — write class/barrier."""
        return self._admit(tenant, table, WRITE, "delete",
                           {"rows": np.asarray(rows, np.int64)}, deadline)

    def submit_update(self, tenant: str, table: str, rows, data,
                      seed: int = 0, *, samples=None,
                      deadline: Optional[float] = None) -> int:
        """Submit an update (tombstone + replacement insert) — write
        class/barrier; `seed` / `samples` as for `submit_insert`."""
        return self._admit(tenant, table, WRITE, "update",
                           {"rows": np.asarray(rows, np.int64),
                            "data": data, "seed": seed,
                            "samples": samples}, deadline)

    # -- results -----------------------------------------------------------

    def response(self, ticket: int) -> Response:
        """The Response for `ticket` (PENDING until a pump resolves it).
        KeyError once the terminal response has been `forget()`-acked or
        evicted past the `max_responses` retention bound."""
        with self._lock:
            return self._responses[ticket]

    def responses(self) -> Dict[int, Response]:
        """Snapshot of every RETAINED ticket's Response (terminals past
        the `max_responses` bound are evicted oldest-first)."""
        with self._lock:
            return dict(self._responses)

    def forget(self, ticket: int) -> Optional[Response]:
        """Ack-and-release one TERMINAL response (returns it, or None if
        unknown/already released) — continuous-stream clients forget
        tickets as they consume them so results are not pinned until
        the retention bound evicts them.  PENDING tickets are refused
        (ValueError): their result has nowhere else to land."""
        with self._lock:
            resp = self._responses.get(ticket)
            if resp is None:
                return None
            if resp.status == PENDING:
                raise ValueError(f"ticket {ticket} is still PENDING")
            return self._responses.pop(ticket)

    def queue_depth(self, tenant: Optional[str] = None) -> int:
        """Pending (admitted, not yet drafted) request count, optionally
        for one tenant."""
        with self._lock:
            return sum(1 for r in self._regs.values() for p in r.pending
                       if tenant is None or p.tenant == tenant)

    def _require(self, table: str) -> _Registration:
        reg = self._regs.get(table)
        if reg is None:
            raise KeyError(f"no table {table!r} registered")
        return reg

    # -- scheduling --------------------------------------------------------

    def pump(self) -> int:
        """Run ONE scheduling round: first apply every table's head run
        of writes (the admission-order barriers), then draft + run one
        POINT batch per table — across ALL tables, so no table's point
        lookups wait behind another table's scan — then one BULK batch
        per table.  Returns the number of requests resolved this
        round."""
        with self._pump_lock:
            t0 = time.perf_counter()
            done = 0
            with obs.span("serve.pump"):
                obs.mark_clock()
                regs = [self._regs[n] for n in list(self._regs)]
                for reg in regs:
                    done += self._apply_head_writes(reg)
                for klass in (POINT, BULK):
                    for reg in regs:
                        done += self._draft_and_run(reg, klass)
                with self._lock:
                    depth = sum(len(r.pending)
                                for r in self._regs.values())
                obs.observe("serve.queue_depth", depth)
            self.stats.pumps += 1
            if self.monitor is not None:
                self.monitor.heartbeat(self.monitor_host,
                                       step_time=time.perf_counter() - t0)
            return done

    def _apply_head_writes(self, reg: _Registration) -> int:
        """Apply the maximal run of writes at the head of `reg`'s admit
        order (they are barriers: nothing admitted before them is still
        pending)."""
        with self._lock:
            writes: List[_Pending] = []
            while reg.pending and reg.pending[0].klass == WRITE:
                writes.append(reg.pending.pop(0))
        done = 0
        for p in writes:
            done += self._run_write(reg, p)
        return done

    def _draft_and_run(self, reg: _Registration, klass: str) -> int:
        """Draft + run one `klass` batch from the admit-order window
        before `reg`'s next write barrier; shed expired requests at
        formation time."""
        done = 0
        with self._lock:
            window: List[_Pending] = []
            for p in reg.pending:
                if p.klass == WRITE:
                    break
                window.append(p)
            shed = [p for p in window
                    if p.deadline is not None
                    and self.clock() > p.deadline]
            cands = [p for p in window
                     if p.klass == klass and p not in shed]
            drafted = self._draft(cands)
            lift = {p.ticket for p in drafted} | {p.ticket for p in shed}
            reg.pending = [p for p in reg.pending
                           if p.ticket not in lift]
        for p in shed:
            self._finish(p, SHED,
                         error="deadline passed before batch formation")
            done += 1
        if drafted:
            done += self._run_batch(reg, drafted, klass)
        return done

    def _draft(self, cands: List[_Pending]) -> List[_Pending]:
        """Fair-share round-robin draft, pow2-bucketed.

        Tenants are visited in order of their head request's (deadline,
        admit seq); each visit takes the tenant's next request (FIFO),
        capped at `fair_share` per tenant when contended.  The drafted
        size then rounds DOWN to a power of two so batch shapes cycle
        through a small closed set and the launch shapes stay warm."""
        if not cands:
            return []
        by_tenant: Dict[str, List[_Pending]] = {}
        for p in cands:
            by_tenant.setdefault(p.tenant, []).append(p)
        inf = float("inf")
        order = sorted(by_tenant, key=lambda t: (
            inf if by_tenant[t][0].deadline is None
            else by_tenant[t][0].deadline, by_tenant[t][0].seq))
        fair = (self.policy.fair_share if len(order) > 1
                else self.batch)
        out: List[_Pending] = []
        taken = dict.fromkeys(order, 0)
        progress = True
        while len(out) < self.batch and progress:
            progress = False
            for t in order:
                if len(out) >= self.batch:
                    break
                if by_tenant[t] and taken[t] < fair:
                    out.append(by_tenant[t].pop(0))
                    taken[t] += 1
                    progress = True
        if self.pow2_buckets and len(out) > 1:
            out = out[:1 << (len(out).bit_length() - 1)]
        return out

    # -- execution ---------------------------------------------------------

    def _submit_one(self, server, p: _Pending) -> int:
        """Forward one drafted request to its underlying server."""
        pl = p.payload
        if p.kind == "query":
            return server.submit(pl["query"], tenant=p.tenant)
        if p.kind == "join":
            return server.submit_join(
                pl["join"], pl["right"],
                right_indexes=pl["right_indexes"],
                strategy=pl["strategy"], tenant=p.tenant)
        if p.kind == "insert":
            return server.submit_insert(pl["data"], pl["seed"],
                                        samples=pl["samples"],
                                        tenant=p.tenant)
        if p.kind == "delete":
            return server.submit_delete(pl["rows"], tenant=p.tenant)
        if p.kind == "update":
            return server.submit_update(pl["rows"], pl["data"], pl["seed"],
                                        samples=pl["samples"],
                                        tenant=p.tenant)
        raise ValueError(f"unknown request kind {p.kind!r}")

    def _run_write(self, reg: _Registration, p: _Pending) -> int:
        """Apply one mutation (isolated: a failing write resolves FAILED
        without poisoning the loop)."""
        server = reg.server
        with obs.span("serve.batch", table=reg.name, klass=WRITE, size=1,
                      tickets=(p.ticket,)):
            self._mark_start([p], WRITE)
            try:
                qid = self._submit_one(server, p)
                res = server.run()
                self._finish(p, OK, result=res[qid])
            except Exception as e:          # noqa: BLE001 — isolate faults
                server.clear_queue()
                self._finish(p, FAILED, error=f"{type(e).__name__}: {e}")
        self.stats.batches += 1
        self.batch_shapes.append((reg.name, WRITE, 1))
        return 1

    def _mark_start(self, drafted: List[_Pending], klass: str) -> None:
        """Stamp batch-formation time + queue-wait histograms."""
        now = self.clock()
        with self._lock:
            for p in drafted:
                resp = self._responses[p.ticket]
                resp.start_t = now
                obs.observe("serve.queue_wait_s",
                            max(0.0, now - resp.submit_t), klass=klass)

    def _run_batch(self, reg: _Registration, drafted: List[_Pending],
                   klass: str) -> int:
        """Run one drafted read batch through the server as ONE shared-
        launch drain; on failure, retry requests individually so only
        the poisoned one resolves FAILED."""
        server = reg.server
        size = len(drafted)
        self.batch_shapes.append((reg.name, klass, size))
        self.stats.batches += 1
        with obs.span("serve.batch", table=reg.name, klass=klass,
                      size=size, tickets=[p.ticket for p in drafted]):
            self._mark_start(drafted, klass)
            try:
                with server.batch_size(size):
                    qids = {p.ticket: self._submit_one(server, p)
                            for p in drafted}
                    res = server.run()
                for p in drafted:
                    self._finish(p, OK, result=res[qids[p.ticket]])
            except Exception:               # noqa: BLE001 — isolate faults
                server.clear_queue()        # drop the failed drain's leftovers
                for p in drafted:
                    try:
                        with server.batch_size(1):
                            qid = self._submit_one(server, p)
                            res = server.run()
                        self._finish(p, OK, result=res[qid])
                    except Exception as e:  # noqa: BLE001
                        server.clear_queue()
                        self._finish(p, FAILED,
                                     error=f"{type(e).__name__}: {e}")
        return size

    def _finish(self, p: _Pending, status: str, *, result=None,
                error: str = "") -> None:
        """Resolve one ticket to a terminal status + bill loop stats."""
        with self._lock:
            resp = self._responses[p.ticket]
            resp.status = status
            resp.result = result
            resp.error = error
            resp.done_t = self.clock()
            self._retire(p.ticket)
            if status == OK:
                self.stats.served += 1
                if (p.deadline is not None
                        and resp.done_t > p.deadline):
                    resp.deadline_missed = True
                    self.stats.deadline_miss += 1
                    obs.count("serve.deadline_miss", 1, tenant=p.tenant)
            elif status == FAILED:
                self.stats.failed += 1
                obs.count("serve.failed", 1, tenant=p.tenant)
            elif status == SHED:
                self.stats.shed += 1
                obs.count("serve.shed", 1, tenant=p.tenant)

    # -- drive modes -------------------------------------------------------

    def run_until_idle(self, max_pumps: int = 100_000) -> Dict[int, Response]:
        """Pump until every admitted request has a terminal response;
        returns the response snapshot.  `max_pumps` guards against a
        runaway loop (it should never bind: every pump with pending
        work resolves at least one request)."""
        pumps = 0
        while self.queue_depth() > 0:
            if pumps >= max_pumps:
                raise RuntimeError("run_until_idle: max_pumps exceeded")
            self.pump()
            pumps += 1
        return self.responses()

    def start(self, interval_s: float = 0.005) -> None:
        """Start the always-on daemon thread: pump whenever work is
        queued, idle-wait `interval_s` between empty rounds."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _forever():
            while not self._stop.is_set():
                if self.pump() == 0:
                    self._stop.wait(interval_s)

        self._thread = threading.Thread(target=_forever, daemon=True,
                                        name="repro-torch-serve-loop")
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the daemon thread (waits for the in-flight pump)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=timeout_s)
        self._thread = None


# ---------------------------------------------------------------------------
# CLI demo: a short mixed-traffic run against one table
# ---------------------------------------------------------------------------

def main(argv=None) -> dict:
    """CLI demo: admit a stream of random point queries through the loop
    and print latency/shed stats (see module docstring)."""
    from repro_torch.core import encrypt as E
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import make_params
    from repro_torch.db.index import SortedIndex
    from repro_torch.db.query_serve import QueryServer
    from repro_torch.db.table import Table

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain path)")
    args = ap.parse_args(argv)

    params = make_params("test-bfv", mode="gadget")
    ks = keygen(params, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    vals = rng.integers(0, params.max_operand // 2,
                        args.rows).astype(np.int64)
    table = Table.from_arrays(ks, "demo", {"value": vals}, args.seed + 1)
    indexes = {"value": SortedIndex.build(ks, table, "value")}
    server = QueryServer(ks, table, indexes=indexes, batch=args.batch)

    loop = ServeLoop(batch=args.batch)
    loop.register("demo", server)
    t0 = time.perf_counter()
    truth = {}
    for i in range(args.requests):
        v = int(rng.choice(vals))
        ct = E.encrypt(ks, v, int(rng.integers(1 << 30)))
        t = loop.submit("tenant%d" % (i % 4), "demo", P.Eq("value", ct))
        truth[t] = np.nonzero(vals == v)[0]
    res = loop.run_until_idle()
    wall = time.perf_counter() - t0
    lat = sorted(r.latency_s for r in res.values() if r.status == OK)
    correct = sum(int(r.status == OK and np.array_equal(
        np.sort(r.result.row_ids), truth[t])) for t, r in res.items())
    out = {
        "device": str(ks.device),
        "requests": args.requests,
        "served": loop.stats.served,
        "rejected": loop.stats.rejected,
        "shed": loop.stats.shed,
        "batches": loop.stats.batches,
        "correct": f"{correct}/{args.requests}",
        "p50_ms": round(1e3 * lat[len(lat) // 2], 3) if lat else None,
        "p99_ms": round(1e3 * lat[min(len(lat) - 1,
                                      int(0.99 * len(lat)))], 3)
        if lat else None,
        "qps": round(args.requests / wall, 2),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
