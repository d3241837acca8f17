"""Fleet fault runtime: heartbeats, straggler detection, failover planning.

At 1000+ nodes the controller must (a) notice dead/slow workers fast,
(b) decide a restart plan from the last durable checkpoint (which, with
NVCache, is at most one step old — synchronous durability), and (c) keep
spares warm.  This module is the control-plane logic, written against an
injectable clock so every policy is unit-testable on CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class WorkerState:
    worker_id: str
    last_step: int = -1
    last_beat: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True

    def rate(self) -> Optional[float]:
        if len(self.step_times) < 2:
            return None
        recent = self.step_times[-8:]
        return sum(recent) / len(recent)


@dataclasses.dataclass
class FailoverPlan:
    restart_step: int
    dead: List[str]
    stragglers: List[str]
    replacements: Dict[str, str]
    remesh: bool                      # no spares left -> elastic re-mesh


class HeartbeatMonitor:
    def __init__(self, *, dead_after_s: float = 30.0,
                 straggler_factor: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.dead_after_s = dead_after_s
        self.straggler_factor = straggler_factor
        self.workers: Dict[str, WorkerState] = {}
        self.spares: List[str] = []
        self.checkpointed_step = -1

    def register(self, worker_id: str, *, spare: bool = False) -> None:
        self.workers[worker_id] = WorkerState(worker_id, last_beat=self.clock())
        if spare:
            self.spares.append(worker_id)

    def beat(self, worker_id: str, step: int) -> None:
        w = self.workers[worker_id]
        now = self.clock()
        if w.last_step >= 0 and step > w.last_step:
            dt = (now - w.last_beat) / max(1, step - w.last_step)
            w.step_times.append(dt)
        w.last_step = step
        w.last_beat = now
        w.alive = True

    def note_checkpoint(self, step: int) -> None:
        self.checkpointed_step = max(self.checkpointed_step, step)

    # ------------------------------------------------------------- policies
    def dead_workers(self) -> List[str]:
        now = self.clock()
        return [w.worker_id for w in self.workers.values()
                if w.worker_id not in self.spares
                and now - w.last_beat > self.dead_after_s]

    def stragglers(self) -> List[str]:
        rates = [w.rate() for w in self.workers.values()
                 if w.rate() is not None and w.worker_id not in self.spares]
        if len(rates) < 3:
            return []
        med = sorted(rates)[len(rates) // 2]
        return [w.worker_id for w in self.workers.values()
                if w.worker_id not in self.spares and w.rate() is not None
                and w.rate() > self.straggler_factor * med]

    def plan(self) -> Optional[FailoverPlan]:
        dead = self.dead_workers()
        stragglers = self.stragglers()
        if not dead and not stragglers:
            return None
        to_replace = dead + stragglers
        replacements, spares = {}, list(self.spares)
        for w in to_replace:
            if spares:
                replacements[w] = spares.pop(0)
        return FailoverPlan(
            restart_step=self.checkpointed_step,
            dead=dead, stragglers=stragglers,
            replacements=replacements,
            remesh=len(replacements) < len(to_replace))

    def apply(self, plan: FailoverPlan) -> None:
        for old, new in plan.replacements.items():
            self.spares.remove(new)
            self.workers.pop(old, None)
        for w in plan.dead:
            self.workers.pop(w, None)
