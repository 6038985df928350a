"""POPE baseline [27]: Partial Order Preserving Encoding.

POPE keeps ciphertexts unordered until queries force comparisons; the
server maintains a buffered POPE-tree and asks the CLIENT to sort/compare
small sets during queries.  The defining cost (paper §6.5: 385 ms vs
HADES 6.5 ms) is the client round-trips — we implement the protocol with
an explicit transport so network latency is a measured, configurable part
of every comparison, exactly as the paper attributes.

Crypto: client-side values are encrypted with a semantically-secure
scheme; the client decrypts privately when asked to compare (POPE's
actual design — the server never learns plaintexts).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from repro_torch.baselines import paillier as P


@dataclasses.dataclass
class Transport:
    """Simulated client<->server link; latency applied per round trip."""
    latency_s: float = 0.001
    rounds: int = 0

    def round_trip(self):
        self.rounds += 1
        if self.latency_s:
            time.sleep(self.latency_s)


class PopeClient:
    """Holds the key; answers comparison oracles (decrypt + compare)."""

    def __init__(self, bits: int = 512):
        self.pub, self.priv = P.keygen(bits)

    def encrypt(self, m: int) -> int:
        return P.encrypt(self.pub, m)

    def compare_oracle(self, ct_a: int, ct_b: int) -> int:
        a = P.decrypt(self.priv, ct_a)
        b = P.decrypt(self.priv, ct_b)
        return (a > b) - (a < b)


class PopeServer:
    """Buffered POPE tree, degenerate-cased to a sorted list + buffer.

    Inserts are O(1) (append to buffer — POPE's cheap-ingest property).
    Queries flush the buffer by asking the client to place each buffered
    ciphertext (binary search => O(log n) round trips per element).
    """

    def __init__(self, client: PopeClient, transport: Transport):
        self.client = client
        self.t = transport
        self.sorted: List[int] = []
        self.buffer: List[int] = []

    def insert(self, ct: int) -> None:
        self.buffer.append(ct)

    def _place(self, ct: int, left: bool = False) -> int:
        """Binary-search insertion point; left=True -> before equal keys
        (inclusive lower bound for range queries)."""
        lo, hi = 0, len(self.sorted)
        while lo < hi:
            mid = (lo + hi) // 2
            self.t.round_trip()                      # ask client to compare
            c = self.client.compare_oracle(ct, self.sorted[mid])
            if c < 0 or (left and c == 0):
                hi = mid
            else:
                lo = mid + 1
        return lo

    def _flush(self) -> None:
        for ct in self.buffer:
            self.sorted.insert(self._place(ct), ct)
        self.buffer = []

    def compare(self, ct_a: int, ct_b: int) -> int:
        """One comparison costs a client round trip (plus any flush)."""
        self._flush()
        self.t.round_trip()
        return self.client.compare_oracle(ct_a, ct_b)

    def range_query(self, ct_lo: int, ct_hi: int) -> List[int]:
        """Inclusive [lo, hi] range."""
        self._flush()
        lo = self._place(ct_lo, left=True)
        hi = self._place(ct_hi, left=False)
        return self.sorted[lo:hi]
