"""Merged Chrome-trace/Perfetto export: host spans + comm events + netsim
(copy of `repro/obs/export.py`).

One run produces three streams of timed facts that previously lived in three
disconnected places:

  * host spans      — `SpanTracer` B/E pairs over driver phases (precompute,
                      stage, scan_chunk, round, eval, materialize): REAL
                      wall-clock of the simulation process;
  * comm events     — the `CommLedger`'s structured `CommEvent` stream: every
                      metered message of the protocol (no time of its own);
  * netsim timeline — `repro_torch.netsim` job DAG replay: SIMULATED wall-clock of
                      the deployment (compute/transfer jobs on links/nodes).

`build_chrome_trace` merges them into one Chrome-trace JSON ("traceEvents"
array, ts/dur in µs) loadable in Perfetto (ui.perfetto.dev) or
chrome://tracing.  The three streams keep separate pids — the host clock and
the simulated clock are *different clocks* and must not be compared across
tracks:

  pid 1 "host"    — B/E duration events, µs of real time since the tracer's
                    first event;
  pid 2 "comm"    — one instant ("i") per CommEvent, one tid per hop.  With a
                    netsim replay supplied, each event is FIFO-matched to the
                    transfer job that carried it (via `CommLedger.event_index`
                    keyed (round, hop, "sender->receiver"), the same key the
                    adapters pin jobs to) and lands at that job's simulated
                    finish time; unmatched events (e.g. uploads a deadline
                    dropped) land at their round's end.  Without a replay, a
                    synthetic stream-order clock is used;
  pid 3 "netsim"  — one X (complete) event per simulated job, one tid per
                    resource, plus "dropped:<client>" instants from
                    `Timeline.dropped` and a per-round drop-count counter.

`validate_chrome_trace` checks the invariants CI's obs-smoke job enforces:
parseable structure, monotonic timestamps per track, matched B/E pairs, and
(optionally) comm-instant count == ledger event count.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any

__all__ = [
    "build_chrome_trace",
    "write_chrome_trace",
    "write_metrics_jsonl",
    "validate_chrome_trace",
]

_S_TO_US = 1e6


def _meta(pid: int, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name}}


def _host_events(tracer) -> list[dict]:
    return [
        {"ph": kind, "pid": 1, "tid": "driver", "name": name,
         "ts": ts * _S_TO_US, "cat": "host"}
        for kind, name, ts in tracer.events
    ]


def _job_queues(jobs) -> dict[tuple, list]:
    """Transfer jobs grouped by the adapters' (round, hop, resource) key, in
    build order — mirrors `CommLedger.event_index` so zip() FIFO-matches."""
    queues: dict[tuple, list] = defaultdict(list)
    for j in jobs:
        if j.kind == "transfer" and j.resource is not None:
            queues[(j.round, j.label, j.resource)].append(j)
    return queues


def _comm_events(ledger, jobs=None, timeline=None) -> list[dict]:
    events = ledger.events
    ts_of = [float(i) for i in range(len(events))]  # synthetic fallback clock
    if jobs is not None and timeline is not None:
        queues = _job_queues(jobs)
        for key, positions in ledger.event_index().items():
            matched = queues.get(key, [])
            for pos, job in zip(positions, matched):
                ts_of[pos] = timeline.job_times[job.job_id][1] * _S_TO_US
            for pos in positions[len(matched):]:  # e.g. deadline-dropped uploads
                r = events[pos].round
                ts_of[pos] = timeline.round_end.get(r, timeline.makespan) * _S_TO_US
    out = [
        {"ph": "i", "pid": 2, "tid": ev.hop, "s": "t", "cat": "comm",
         "name": f"{ev.sender}->{ev.receiver}", "ts": ts_of[i],
         "args": {"round": ev.round, "phase": ev.phase, "bits": ev.n_bits}}
        for i, ev in enumerate(events)
    ]
    out.sort(key=lambda e: (e["tid"], e["ts"]))
    return out


def _netsim_events(jobs, timeline) -> list[dict]:
    out = []
    for j in jobs:
        start, finish = timeline.job_times[j.job_id]
        out.append({
            "ph": "X", "pid": 3, "tid": j.resource or f"({j.kind})",
            "name": f"{j.label}@r{j.round}", "cat": "netsim",
            "ts": start * _S_TO_US, "dur": (finish - start) * _S_TO_US,
            "args": {"round": j.round, "kind": j.kind, "tracked": j.tracked},
        })
    for r, clients in sorted(timeline.dropped.items()):
        ts = timeline.round_end.get(r, timeline.makespan) * _S_TO_US
        for c in sorted(clients):
            out.append({"ph": "i", "pid": 3, "tid": "dropped", "s": "t",
                        "name": f"dropped:{c}", "cat": "netsim",
                        "ts": ts, "args": {"round": r}})
    for r, n in sorted(timeline.drop_counts().items()):
        out.append({"ph": "C", "pid": 3, "tid": "drops", "name": "dropped_clients",
                    "ts": timeline.round_end.get(r, timeline.makespan) * _S_TO_US,
                    "args": {"count": n}})
    # emission order == schedule order per track (the simulator may run jobs
    # out of build order across resources)
    out.sort(key=lambda e: (str(e["tid"]), e["ts"]))
    return out


def build_chrome_trace(obs=None, ledger=None, jobs=None,
                       timeline=None) -> dict[str, Any]:
    """Merge whichever streams the caller has into one Chrome-trace dict.

    All arguments optional: pass `obs` (a `RunTelemetry`) for the host
    track, `ledger` for the comm track, and a `(jobs, timeline)` pair from
    `netsim.replay_run` for the netsim track (which also time-anchors the
    comm instants)."""
    trace_events: list[dict] = []
    if obs is not None:
        trace_events.append(_meta(1, "host (real wall-clock)"))
        trace_events += _host_events(obs.tracer)
    if ledger is not None and ledger.events:
        trace_events.append(_meta(2, "comm (CommLedger events)"))
        trace_events += _comm_events(ledger, jobs, timeline)
    if jobs is not None and timeline is not None:
        trace_events.append(_meta(3, "netsim (simulated deployment)"))
        trace_events += _netsim_events(jobs, timeline)
    meta: dict[str, Any] = {}
    if timeline is not None:
        meta = {"makespan_s": timeline.makespan,
                "dropped_bits": timeline.dropped_bits,
                "drop_counts": {str(r): n
                                for r, n in timeline.drop_counts().items()}}
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": meta}


def write_chrome_trace(trace: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(trace, f)


def write_metrics_jsonl(obs, path) -> int:
    """Flat per-round telemetry rows as JSONL; returns the row count."""
    rows = obs.metrics_rows()
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return len(rows)


def validate_chrome_trace(trace: dict,
                          expected_comm_events: int | None = None) -> list[str]:
    """Structural invariants of a merged trace; returns problems (empty ==
    valid).  Checked: traceEvents list present, every event has a ts >= 0,
    per-(pid, tid) timestamps monotonic non-decreasing, B/E pairs matched
    and well nested per track, X durations non-negative, and — when
    `expected_comm_events` is given — exactly that many comm instants."""
    problems: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts: dict[tuple, float] = {}
    stacks: dict[tuple, list[str]] = defaultdict(list)
    n_comm = 0
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        key = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ts < last_ts.get(key, 0.0):
            problems.append(
                f"event {i}: ts {ts} < {last_ts[key]} on track {key}")
        last_ts[key] = ts
        if ph == "B":
            stacks[key].append(ev.get("name", ""))
        elif ph == "E":
            if not stacks[key]:
                problems.append(f"event {i}: E without B on track {key}")
            elif stacks[key][-1] != ev.get("name", ""):
                problems.append(
                    f"event {i}: E {ev.get('name')!r} closes "
                    f"B {stacks[key][-1]!r} on track {key}")
            else:
                stacks[key].pop()
        elif ph == "X":
            if ev.get("dur", 0) < 0:
                problems.append(f"event {i}: negative dur")
        elif ph == "i" and ev.get("cat") == "comm":
            n_comm += 1
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed B events {stack} on track {key}")
    if expected_comm_events is not None and n_comm != expected_comm_events:
        problems.append(
            f"comm instants {n_comm} != ledger events {expected_comm_events}")
    return problems
