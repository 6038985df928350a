"""One cell: its set-up, its clients and its measured window.

Set-up makes everything from the seed on the cell's device: the keys,
the encrypted column, the index (if the traffic has one), the server
and the serving loop in front of it, the request pool (encrypted once,
client-side) and the warm-up traffic, which drives the same loop with
the same clients as the window, a fixed amount of it.

The window runs on one thread: every reader client has one request in
flight (a closed loop, cycling through the pool), inserts of fresh rows
arrive at the traffic's fixed rate (an open loop, each timed from its
due time), `ServeLoop.pump()` runs one scheduling round, and after each
round the readers whose answers came back and the inserts that fell due
are submitted.  At the close, nothing more is submitted and the loop
drains what was admitted.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Optional

import numpy as np

from hbench import traffic as TR

TABLE = "t"


def close_by(seconds: float) -> float:
    """The latest a window of `seconds` closes, from its open."""
    return min(1.5 * seconds, seconds + 5.0)


@dataclasses.dataclass
class ReadRecord:
    tree: tuple
    admitted_inserts: int          # inserts admitted before this read
    submit_t: float
    done_t: Optional[float] = None
    status: str = "PENDING"
    row_ids: Optional[np.ndarray] = None


@dataclasses.dataclass
class WriteRecord:
    index: int                     # insert number, in admission order
    rows: int
    submit_t: float
    done_t: Optional[float] = None
    status: str = "PENDING"
    row_ids: Optional[np.ndarray] = None


class Clients:
    """Closed-loop readers, and inserts on an open-loop schedule, over
    one `ServeLoop` table."""

    def __init__(self, loop, pool: list, trees: list, writes, readers: int,
                 insert_rate: float):
        self.loop = loop
        self.pool, self.trees = pool, trees
        self.writes = writes              # i -> (values, encryption seed)
        self.readers = readers
        self.insert_rate = insert_rate    # inserts a second, evenly spaced
        self.origin: Optional[float] = None   # the schedule's start
        self.scheduled = 0                # inserts of the schedule so far
        self.next_read = 0
        self.inserts = 0                  # inserts admitted so far
        self.open: dict = {}              # ticket -> (client, record)
        self.reads: list = []
        self.written: list = []

    def _read(self, client: int) -> None:
        i = self.next_read % len(self.pool)
        self.next_read += 1
        rec = ReadRecord(self.trees[i], self.inserts, time.perf_counter())
        t = self.loop.submit(f"r{client}", TABLE, self.pool[i])
        self.open[t] = (("r", client), rec)
        self.reads.append(rec)

    def _write(self, due: float) -> None:
        """Submit the next insert; its latency counts from `due`."""
        values, seed = self.writes(self.inserts)
        rec = WriteRecord(self.inserts, len(values), due)
        t = self.loop.submit_insert("w", TABLE, {"value": values}, seed)
        self.inserts += 1
        self.open[t] = (("w", 0), rec)
        self.written.append(rec)

    def _due_writes(self, now: float) -> None:
        """Submit every insert of the schedule that is due by `now`, in
        order (those that fell due during a pump go in after it)."""
        if self.origin is None or not self.insert_rate:
            return
        while True:
            due = self.origin + self.scheduled / self.insert_rate
            if due > now:
                return
            self._write(due)
            self.scheduled += 1

    def _collect(self) -> list:
        """Records of the tickets answered since the last call, their
        clients in the order the answers came."""
        done = []
        for t in list(self.open):
            resp = self.loop.response(t)
            if not resp.done:
                continue
            client, rec = self.open.pop(t)
            rec.done_t, rec.status = resp.done_t, resp.status
            if resp.status == "OK":
                rec.row_ids = np.asarray(resp.result.row_ids)
            self.loop.forget(t)
            done.append((resp.done_t, t, client))
        return [c for _, _, c in sorted(done)]

    def start(self, origin: Optional[float] = None) -> None:
        """Every reader submits; from `origin` on (if given) inserts
        follow the schedule."""
        self.origin, self.scheduled = origin, 0
        self._due_writes(time.perf_counter())
        for c in range(self.readers):
            self._read(c)

    def run(self, until) -> float:
        """Pump; resubmit answered readers and submit due inserts, until
        `until(now)` is true after a pump; returns that time, by which
        every insert due has been submitted.  Nothing is drained."""
        while True:
            self.loop.pump()
            now = time.perf_counter()
            finished = self._collect()
            self._due_writes(now)
            if until(now):
                return now
            for kind, c in finished:
                if kind == "r":
                    self._read(c)

    def run_budget(self, reads: int, inserts: int) -> None:
        """Warm-up: submit exactly `reads` reads in all (readers resubmit
        while some are left) and `inserts` inserts, one after another,
        then drain."""
        left = {"r": reads - self.readers, "w": inserts}
        if left["r"] < 0:
            raise ValueError("a warm-up budget below the client count")
        if left["w"]:
            left["w"] -= 1
            self._write(time.perf_counter())
        while self.open:
            self.loop.pump()
            for kind, c in self._collect():
                if left[kind] > 0:
                    left[kind] -= 1
                    (self._read(c) if kind == "r"
                     else self._write(time.perf_counter()))

    def drain(self) -> None:
        """Answer everything admitted; submit nothing more."""
        while self.open:
            self.loop.pump()
            self._collect()


class Cell:
    """One (configuration, traffic) cell on one device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device

    def setup(self) -> None:
        from repro_torch.core.keys import keygen
        from repro_torch.core.params import make_params
        from repro_torch.db.index import SortedIndex
        from repro_torch.db.query_serve import QueryServer
        from repro_torch.db.serve_loop import ServeLoop
        from repro_torch.db.table import Table

        from hbench.data import Column

        cfg, tr, seed = self.config, self.traffic, self.seed
        self.column = Column(cfg, np.random.default_rng(TR.fold(seed, 1)))
        params = make_params(cfg["profile"], mode=cfg["mode"])
        self.ks = ks = keygen(params, TR.fold(seed, 2), device=self.device)
        col = cfg["column"]
        self.table = Table.from_arrays(ks, cfg["name"],
                                       {col: self.column.values},
                                       TR.fold(seed, 3))
        indexes = ({col: SortedIndex.build(ks, self.table, col)}
                   if tr.get("index") else {})
        self.server = QueryServer(
            ks, self.table, indexes=indexes, batch=tr["batch"],
            compact_threshold=tr.get("compact_threshold"))
        self.loop = ServeLoop(batch=tr["batch"], clock=time.perf_counter)
        self.loop.register(TABLE, self.server)
        self.trees = TR.read_pool(tr, self.column,
                                  np.random.default_rng(TR.fold(seed, 4)))
        self.pool = TR.encrypt_pool(ks, self.trees, col, TR.fold(seed, 5))
        self.insert_rows: list = []
        self.clients = Clients(self.loop, self.pool, self.trees,
                               self._insert, tr["readers"],
                               float(tr.get("insert_rate", 0)))
        self.clients.start()
        self.clients.run_budget(tr["warm_reads"], tr.get("warm_inserts", 0))
        self._sync()

    def _insert(self, i: int) -> tuple:
        """Insert i's values and encryption seed."""
        values = TR.insert_values(self.column, self.seed, i,
                                  self.traffic["insert_rows"])
        self.insert_rows.append(values)
        return values, TR.fold(self.seed, 12, i)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> "Window":
        """The measured window: readers busy and inserts on schedule from
        the open until the end of the first pump past `seconds` at which
        the table is back in the state it opened in, with no delta
        pending (at once where nothing is written; at the latest
        `close_by(seconds)`), so that a window holds whole write cycles
        (not drained)."""
        c = self.clients
        self._check_slots(close_by(seconds))
        c.reads, c.written = [], []
        marks = (len(self.loop.batch_shapes), len(self.server.batch_log))
        self._sync()
        gc.collect()
        gc.freeze()      # set-up's objects: no collector pass rescans them
        t0 = time.perf_counter()
        c.start(origin=t0)
        table, last = self.table, close_by(seconds)
        t1 = c.run(lambda now: now - t0 >= last or (
            now - t0 >= seconds and table.n_delta == 0))
        self._sync()
        return Window(t0, t1, c.reads, c.written,
                      self.loop.batch_shapes[marks[0]:],
                      self.server.batch_log[marks[1]:],
                      self.traffic["batch"])

    def _check_slots(self, longest: float) -> None:
        """Refuse a window whose scheduled inserts could outgrow the
        slots the configured rows pad to: past them a compaction pads
        the table to twice its slots, which is another deployment (and
        on one card, for hg38-bfv, more memory than it has)."""
        rate = self.clients.insert_rate
        if not rate:
            return
        rows = len(self.column.values)
        slots = 1 << (rows - 1).bit_length()
        most = self.clients.inserts + math.ceil(rate * longest) + 1
        grown = rows + most * self.traffic["insert_rows"]
        if grown > slots:
            raise ValueError(
                f"a window of up to {longest:g} s admits up to {most} "
                f"inserts: {grown} rows, past the table's {slots} slots")

    def free(self) -> None:
        """Drop the program's state (keys, table, index, server, loop,
        pool); the plaintext column and the inserts' rows stay."""
        self.ks = self.table = self.server = self.loop = None
        self.pool = self.clients = None
        gc.unfreeze()

    def read_back(self) -> ReadRecord:
        """After the drain: one read of the whole domain through the
        loop, which has to return every row, acknowledged inserts
        included."""
        tree = ("range", *self.column.domain)
        query, = TR.encrypt_pool(self.ks, [tree], self.config["column"],
                                 TR.fold(self.seed, 6))
        c = self.clients
        rec = ReadRecord(tree, c.inserts, time.perf_counter())
        c.open[self.loop.submit("check", TABLE, query)] = (("r", -1), rec)
        c.drain()
        return rec


@dataclasses.dataclass
class Window:
    """What one measured window did, as the metric readers see it."""
    t0: float
    t1: float
    reads: list
    writes: list
    batch_shapes: list             # (table, class, size) per drafted batch
    batch_log: list                # the server's BatchStats of the window
    batch_cap: int
    setup_s: float = 0.0
    peak_bytes: Optional[int] = None       # the window's peak
    run_peak_bytes: Optional[int] = None   # the whole run's peak
    spans: Optional[list] = None   # obs spans (name, t0, t1), traced only
    counters: Optional[dict] = None    # obs counters, traced only
    device: object = None          # devtrace.DeviceTrace, traced only
    kernels: object = None         # devtrace.KernelWork, traced only
    offset_ns: int = 0             # profiler clock - perf clock, traced

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def ok_reads(self) -> list:
        """Reads answered OK by the close."""
        return [r for r in self.reads
                if r.status == "OK" and r.done_t <= self.t1]

    def read_latencies_ms(self) -> np.ndarray:
        """Submit-to-answer ms of every read of the window (the drain's
        answers included)."""
        return np.asarray([1e3 * (r.done_t - r.submit_t)
                           for r in self.reads if r.done_t is not None])
