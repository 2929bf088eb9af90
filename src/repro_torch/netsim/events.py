"""Deterministic event-driven simulator: job DAGs + serial resources -> timestamps.

The adapters (repro_torch/netsim/adapters.py) compile a training run's `CommEvent`
stream into `Job`s — compute jobs pinned to a node, transfer jobs pinned to a
directed link — wired by explicit dependencies that encode each algorithm's
barrier structure:

  * Fed-CHS     — interaction barriers inside the active cluster, then ONE
                  ES->ES transfer the whole next round depends on: the serial
                  chain emerges from the DAG, it is not special-cased.
  * FedAvg      — all clients' (download, compute, upload) chains share only
                  the per-round PS barrier: the round costs the max over
                  parallel clients, again purely from the DAG.
  * Hier-Local-QSGD — two barrier levels: per-cluster interaction barriers,
                  then the PS waits on every ES upload before broadcasting.
  * WRWGD       — a pure chain (compute, hop, compute, hop, ...).

Execution model (classic list scheduling):
  start(job)  = max(finish(dep) for dep in deps, availability(resource))
  finish(job) = start(job) + duration
Each resource (a node, or a directed link) carries one job at a time, FIFO in
ready order; ties broken by job id — so the timeline is a pure function of
the job list.  Durations come from `links.NetworkModel`, which is itself
deterministic given (seed, message) — the whole pipeline satisfies the
"identical event timelines for identical (seed, config)" contract.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Sequence

__all__ = ["Job", "JobTimes", "Timeline", "simulate"]


@dataclasses.dataclass(frozen=True)
class Job:
    """One unit of simulated work.

    `resource` serializes execution (node name for compute, "a->b" for a
    directed link, None for zero-cost barriers); `deps` are job ids that
    must finish first.  `tracked=False` marks work the protocol has
    abandoned (a deadline-dropped client's partial download/compute chain):
    it appears in the timeline for inspection but counts toward neither
    round completion nor the makespan (the adapters also give such jobs no
    resource, so abandoned work never queues ahead of live work).
    """

    job_id: int
    kind: str                      # "compute" | "transfer" | "barrier" | "deadline"
    duration: float
    resource: str | None = None
    deps: tuple[int, ...] = ()
    round: int = 0
    label: str = ""
    tracked: bool = True


class JobTimes(dict):
    """job_id -> (start, finish)."""


@dataclasses.dataclass
class Timeline:
    """Resolved wall-clock schedule of one simulated run.

    `dropped` / `dropped_bits` are filled by the adapters when a per-round
    reporting deadline is in force (see `adapters.timeline_for`): clients
    whose broadcast->compute->upload chain missed the deadline, and the
    uplink bits their never-sent uploads would have cost.
    """

    job_times: JobTimes
    round_end: dict[int, float]    # round -> completion time of its last job
    makespan: float
    dropped: dict[int, frozenset] = dataclasses.field(default_factory=dict)
    dropped_bits: int = 0

    def drop_counts(self) -> dict[int, int]:
        """Per-round deadline-dropped client counts (empty without a
        deadline) — the shape the timeline exporter and the summary tables
        consume."""
        return {r: len(c) for r, c in sorted(self.dropped.items()) if c}

    def round_duration(self, round_idx: int) -> float:
        """Wall-clock between the end of the previous round and this one."""
        prev = [r for r in self.round_end if r < round_idx]
        start = self.round_end[max(prev)] if prev else 0.0
        return self.round_end[round_idx] - start

    def time_until(self, round_idx: int) -> float:
        """Wall-clock at the first recorded round >= round_idx (the timing
        analogue of `CommLedger.bits_until`)."""
        for r in sorted(self.round_end):
            if r >= round_idx:
                return self.round_end[r]
        return self.makespan


def simulate(jobs: Sequence[Job]) -> Timeline:
    """Resolve a job DAG into start/finish timestamps.

    Deterministic: jobs become ready when all deps finished, run on their
    resource in (ready_time, job_id) order, and never preempt.
    """
    by_id = {j.job_id: j for j in jobs}
    assert len(by_id) == len(jobs), "duplicate job ids"
    children: dict[int, list[int]] = defaultdict(list)
    missing = defaultdict(int)
    for j in jobs:
        for d in j.deps:
            assert d in by_id, f"job {j.job_id} depends on unknown job {d}"
            children[d].append(j.job_id)
            missing[j.job_id] += 1

    ready_time = {j.job_id: 0.0 for j in jobs}
    heap = [(0.0, j.job_id) for j in jobs if missing[j.job_id] == 0]
    heapq.heapify(heap)
    resource_free: dict[str, float] = defaultdict(float)
    times = JobTimes()
    round_end: dict[int, float] = {}

    while heap:
        ready, jid = heapq.heappop(heap)
        job = by_id[jid]
        start = ready
        if job.resource is not None:
            start = max(start, resource_free[job.resource])
        finish = start + job.duration
        if job.resource is not None:
            resource_free[job.resource] = finish
        times[jid] = (start, finish)
        if job.tracked:
            round_end[job.round] = max(round_end.get(job.round, 0.0), finish)
        for child in children[jid]:
            ready_time[child] = max(ready_time[child], finish)
            missing[child] -= 1
            if missing[child] == 0:
                heapq.heappush(heap, (ready_time[child], child))

    assert len(times) == len(jobs), "dependency cycle: not all jobs ran"
    makespan = max((times[j.job_id][1] for j in jobs if j.tracked), default=0.0)
    return Timeline(times, round_end, makespan)
