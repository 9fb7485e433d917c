"""Per-node compute layer: FIFO queues, service state, failure bookkeeping.

``NodeBank`` owns what each computing node (cloud + every edge) is doing at
any instant — its FIFO queue (a ``collections.deque``: the pipeline pops
from the head on every service start, which must not be O(queue length)),
the in-flight task, cumulative busy seconds and served counts, and the set
of dead nodes.  It is purely mechanical: *where* work goes (Eq. 7) and
*when* events fire stay in the orchestrator.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import CLOUD
from repro_torch.system.events import Task
from repro_torch.system.scenario import Scenario


class NodeBank:
    """Queue/service/failure state for every computing node."""

    def __init__(self, sc: Scenario, service_s: Dict[int, float],
                 rng: np.random.Generator):
        self.sc = sc
        self.service_s = dict(service_s)
        self.rng = rng
        self.queues: Dict[int, Deque[Task]] = {
            n: collections.deque() for n in service_s}
        self.busy: Dict[int, bool] = {n: False for n in service_s}
        self.inflight: Dict[int, Optional[Tuple[Task, float, float]]] = {
            n: None for n in service_s}
        self.busy_s: Dict[int, float] = {n: 0.0 for n in service_s}
        self.served: Dict[int, int] = {n: 0 for n in service_s}
        self.dead: set = set()

    # --- stochastic service ---------------------------------------------------
    def service_time(self, node: int, phase: str) -> float:
        base = self.service_s[node]
        if phase == "reclassify" and node != CLOUD:
            base *= self.sc.reclassify_factor
        return float(base * self.rng.lognormal(0.0, 0.15))

    # --- queue mechanics ------------------------------------------------------
    def push(self, node: int, task: Task) -> None:
        self.queues[node].append(task)

    def begin(self, t: float, node: int) -> Tuple[Task, float]:
        """Pop the head of ``node``'s queue and start serving it at ``t``."""
        task = self.queues[node].popleft()
        self.busy[node] = True
        svc = self.service_time(node, task.phase)
        self.inflight[node] = (task, svc, t)
        self.busy_s[node] += svc
        return task, svc

    def complete(self, node: int) -> None:
        self.busy[node] = False
        self.inflight[node] = None

    def occupancy(self, node: int) -> int:
        """Queued + in-service items (the per-tick timeline sample)."""
        return len(self.queues[node]) + int(self.busy[node])

    # --- failure --------------------------------------------------------------
    def fail(self, t: float, node: int) -> List[Task]:
        """Kill ``node`` at ``t``; returns its stranded tasks (the aborted
        in-flight task first, then the queue in FIFO order).

        An aborted mid-service task did real work from its start until the
        failure; only the unserved remainder is deducted from busy time."""
        self.dead.add(node)
        stranded = list(self.queues[node])
        self.queues[node].clear()
        if self.inflight[node] is not None:
            task, svc, started = self.inflight[node]
            stranded.insert(0, task)
            self.inflight[node] = None
            self.busy_s[node] -= max(0.0, svc - (t - started))
        self.busy[node] = False
        return stranded
