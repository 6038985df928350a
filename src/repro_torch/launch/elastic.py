"""Elastic scaling + straggler mitigation (the fleet-level control loop).

On a real fleet this daemon would:
  1. heartbeat every host; mark a host dead after `dead_after` missed beats
     (node failure) or persistently slow steps (straggler);
  2. tear the mesh down to the surviving host set, re-run
     `make_production_mesh`-style construction over fewer devices;
  3. restore the latest checkpoint (mesh-agnostic by construction —
     train/checkpoint.py stores full arrays) and resume from the same data
     index (counter-based pipeline => no sample skew).

The logic is expressed over *simulated* device sets — the decision logic
(who is dead, what mesh shape to rebuild) is the part that must be
correct; the transport is deployment-specific.  `db.serve_loop.ServeLoop`
heartbeats a `FleetMonitor` from every pump, so a stalled serving host
goes dead by the same rule as a stalled training host.

The port of `repro.launch.elastic` without `resume_plan`, which reads the
training checkpoints (`train/`, not ported yet).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    step_times: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ElasticConfig:
    beat_interval_s: float = 10.0
    dead_after: int = 3                 # missed beats
    straggler_factor: float = 3.0       # x median step time
    straggler_strikes: int = 5
    min_hosts: int = 1


class FleetMonitor:
    """Tracks heartbeats + step times, decides evictions and mesh shape."""

    def __init__(self, cfg: ElasticConfig, host_ids: List[int],
                 now: Optional[float] = None):
        now = time.time() if now is None else now
        self.cfg = cfg
        self.hosts: Dict[int, HostState] = {
            h: HostState(h, now) for h in host_ids}
        self.strikes: Dict[int, int] = {h: 0 for h in host_ids}

    def heartbeat(self, host_id: int, step_time: Optional[float] = None,
                  now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        h = self.hosts[host_id]
        h.last_beat = now
        if step_time is not None:
            h.step_times.append(step_time)

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        limit = self.cfg.beat_interval_s * self.cfg.dead_after
        return [h.host_id for h in self.hosts.values()
                if now - h.last_beat > limit]

    def stragglers(self) -> List[int]:
        times = [h.step_times[-1] for h in self.hosts.values()
                 if h.step_times]
        if len(times) < 3:
            return []
        med = sorted(times)[len(times) // 2]
        out = []
        for h in self.hosts.values():
            if h.step_times and h.step_times[-1] > \
                    self.cfg.straggler_factor * med:
                self.strikes[h.host_id] += 1
                if self.strikes[h.host_id] >= self.cfg.straggler_strikes:
                    out.append(h.host_id)
            else:
                self.strikes[h.host_id] = 0
        return out

    def evict(self, host_ids: List[int]) -> None:
        for h in host_ids:
            self.hosts.pop(h, None)
            self.strikes.pop(h, None)

    def surviving(self) -> List[int]:
        return sorted(self.hosts)


def plan_mesh(num_devices: int, model_parallel: int = 16
              ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (data, model) mesh that fits the surviving device set.

    Keeps the model axis fixed (weight shards must stay complete) and
    shrinks the data axis — the standard elastic-downscale move.  Falls
    back to smaller model axes when fewer than `model_parallel` devices
    survive.
    """
    while model_parallel > 1 and num_devices < model_parallel:
        model_parallel //= 2
    data = max(1, num_devices // model_parallel)
    return (data, model_parallel), ("data", "model")
