"""Per-algorithm timing adapters: `CommEvent` streams -> job DAGs -> timelines.

A driver run already recorded *what* was sent (hop, bits, sender, receiver,
round, interaction phase) in its `CommLedger`; the adapter's job is to add
the *ordering semantics* the protocol implies and the *compute* the messages
bracket:

  * every in-cluster interaction is  broadcast -> E local steps -> upload,
    with an aggregation barrier before the next interaction;
  * Fed-CHS appends one ES->ES transfer per round that the entire next round
    depends on (the serial chain);
  * FedAvg's round is one interaction of E=K against the PS over the WAN,
    all clients in parallel;
  * Hier-Local-QSGD runs every cluster's interaction chain in parallel, then
    a two-level barrier: PS waits for all ES uploads, ESs wait for the PS
    broadcast;
  * WRWGD alternates compute and a client->client hop — a pure chain.

E is recovered from the stream itself (K total steps spread over the
observed number of interaction phases), so the adapter needs only what a
deployment would know statically: K, the batch size, and the model size.

The same recorded run can be re-timed under any number of `NetworkModel`s —
the straggler/bandwidth sweeps in examples/torch_time_to_accuracy.py re-use one
training run per algorithm and only re-run this (cheap, host-side) replay.

Deadlines (`deadline_s`, per interaction): real aggregators do not wait
forever — a client whose broadcast -> compute -> upload chain exceeds the
reporting deadline is DROPPED: its upload never happens (those bits are
saved, tallied in `Timeline.dropped_bits`), but the aggregator still waits
out the full deadline before closing the phase (wall-clock wasted; the
client abandons its partial chain, which stays in the timeline untracked
and resource-free).  This is a timing-layer re-interpretation of a recorded
run — the training trajectory is unchanged, which keeps the replay cheap;
pair it with a `repro_torch.part` sampler at training time when the dropouts
should also affect learning.  The drop decision evaluates chains at the
*attempted* fan-in (conservative under `shared_ingress`); surviving uploads
are then charged the post-drop fan-in.  Pass-through
rounds (a `repro_torch.part` run whose active cluster was empty) carry no
wireless phases — the round is just its ES->ES model hop.  WRWGD's walk has
no aggregation phase, so deadlines don't apply to it (a pass-through walk
round is still charged its local compute: the event stream alone cannot
distinguish it).
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.netsim.events import Job, Timeline, simulate
from repro_torch.netsim.links import NetworkModel, sgd_step_flops

__all__ = ["build_jobs", "replay_run", "timeline_for", "simulate_run",
           "time_to_accuracy"]

_WIRELESS_UP = ("client_to_es", "client_to_ps")
_WIRELESS_DOWN = ("es_to_client", "ps_to_client")


class _JobGraph:
    def __init__(self, net: NetworkModel, deadline_s: float | None = None):
        self.net = net
        self.deadline_s = deadline_s
        self.jobs: list[Job] = []
        self.dropped: dict[int, set[str]] = defaultdict(set)
        self.dropped_bits: int = 0

    def transfer_duration(self, ev, fan_in=1) -> float:
        return self.net.transfer_time(ev.hop, ev.sender, ev.receiver, ev.n_bits,
                                      ev.round, ev.phase, fan_in)

    def transfer(self, ev, deps, label="", fan_in=1, duration=None) -> int:
        dur = self.transfer_duration(ev, fan_in) if duration is None else duration
        return self._add("transfer", dur, f"{ev.sender}->{ev.receiver}", deps,
                         ev.round, label or ev.hop)

    def compute(self, node, flops, round_idx, deps) -> int:
        dur = self.net.compute_time(node, flops, round_idx)
        return self._add("compute", dur, node, deps, round_idx, "local_sgd")

    def barrier(self, deps, round_idx) -> int:
        return self._add("barrier", 0.0, None, deps, round_idx, "barrier")

    def _add(self, kind, duration, resource, deps, round_idx, label,
             tracked=True) -> int:
        jid = len(self.jobs)
        self.jobs.append(Job(jid, kind, duration, resource, tuple(deps), round_idx,
                             label, tracked))
        return jid


def _phases(events):
    by_phase = defaultdict(list)
    for ev in events:
        by_phase[ev.phase].append(ev)
    return [by_phase[p] for p in sorted(by_phase)]


def _interaction(b: _JobGraph, phase_events, step_flops, entry_deps) -> list[int]:
    """One broadcast -> compute -> upload interaction for one server's
    clients; returns the upload job ids (the aggregation barrier inputs)."""
    down_events = [e for e in phase_events if e.hop in _WIRELESS_DOWN]
    up_events = [e for e in phase_events if e.hop in _WIRELESS_UP]
    downs = {e.receiver: e for e in down_events}
    ups = {e.sender: e for e in up_events}
    # one broadcast + one upload per client per interaction — duplicate
    # (sender, receiver) events (record(count>1) with metadata) would be
    # silently collapsed here, diverging time from bits
    assert len(downs) == len(down_events) and len(ups) == len(up_events), \
        "duplicate per-client messages in one interaction phase"
    assert downs.keys() == ups.keys(), "unpaired broadcast/upload in interaction"
    # pass 1 — deadline triage: a client whose chain would overrun the
    # reporting deadline is dropped.  The decision uses the *attempted*
    # fan-in (everyone starts uploading), which is conservative under
    # shared_ingress.
    dropped = set()
    if b.deadline_s is not None:
        for client, down in downs.items():
            chain = (b.transfer_duration(down)
                     + b.net.compute_time(client, step_flops, down.round)
                     + b.transfer_duration(ups[client], fan_in=len(ups)))
            if chain > b.deadline_s:
                dropped.add(client)
    # pass 2 — build jobs.  A dropped client abandons the round's work at the
    # deadline: its partial download/compute stay in the timeline (untracked,
    # for inspection) but hold NO resources — so the round closes at
    # max(kept uploads, deadline), and no later phase ever queues behind
    # abandoned work (which keeps pass 1's chains-start-at-phase-entry
    # arithmetic exact).  Surviving uploads split the aggregator's bandwidth
    # over the post-drop fan-in.
    kept_fan_in = len(ups) - len(dropped)
    up_jobs = []
    for client, down in sorted(downs.items()):
        if client in dropped:
            d = b._add("transfer", b.transfer_duration(down), None, entry_deps,
                       down.round, down.hop, tracked=False)
            b._add("compute", b.net.compute_time(client, step_flops, down.round),
                   None, [d], down.round, "local_sgd", tracked=False)
            # the upload never happens: bits saved, deadline waited out below
            b.dropped[down.round].add(client)
            b.dropped_bits += ups[client].n_bits
            continue
        d = b.transfer(down, entry_deps)
        c = b.compute(client, step_flops, down.round, [d])
        up_jobs.append(b.transfer(ups[client], [c], fan_in=kept_fan_in))
    if dropped:
        # the aggregator closes the phase no earlier than the full deadline
        up_jobs.append(b._add("deadline", b.deadline_s, None, entry_deps,
                              phase_events[0].round, "deadline"))
    return up_jobs


def _in_cluster_phases(events):
    """Split a round's events into wireless interaction phases vs the rest."""
    wireless, rest = [], []
    for ev in events:
        (wireless if ev.hop in _WIRELESS_UP + _WIRELESS_DOWN else rest).append(ev)
    return _phases(wireless), rest


def _steps_per_interaction(local_steps: int, n_phases: int) -> int:
    assert n_phases > 0 and local_steps % n_phases == 0, \
        f"K={local_steps} does not split over {n_phases} observed interactions"
    return local_steps // n_phases


def _compile(result, net: NetworkModel, *, local_steps: int, batch_size: int,
             num_params: int, deadline_s: float | None = None) -> _JobGraph:
    """Compile a run's event stream into the algorithm's job DAG; the
    returned job graph also carries deadline-dropout bookkeeping."""
    adapters = {
        "fed_chs": _build_sequential,
        "wrwgd": _build_walk,
        "fedavg": _build_star,
        "hier_local_qsgd": _build_hier,
    }
    events = result.ledger.round_events()
    assert events, "run has no structured events (ledger.track_events off?)"
    flops1 = sgd_step_flops(num_params, batch_size)
    if deadline_s is None:
        deadline_s = net.deadline_s
    b = _JobGraph(net, deadline_s)
    adapters[result.name](b, events, local_steps, flops1)
    return b


def build_jobs(result, net: NetworkModel, *, local_steps: int, batch_size: int,
               num_params: int, deadline_s: float | None = None) -> list[Job]:
    """Compile a run's event stream into the algorithm's job DAG."""
    return _compile(result, net, local_steps=local_steps, batch_size=batch_size,
                    num_params=num_params, deadline_s=deadline_s).jobs


def _build_sequential(b, events, local_steps, flops1):
    """Fed-CHS: interaction barriers inside the active cluster, then the
    round's single ES->ES model pass gates everything that follows.  A
    pass-through round (whole cluster unavailable: no wireless phases in the
    stream) is just the forwarded-model hop."""
    prev: list[int] = []
    for t in sorted(events):
        phases, rest = _in_cluster_phases(events[t])
        if phases:
            step_flops = _steps_per_interaction(local_steps, len(phases)) * flops1
            for phase_events in phases:
                ups = _interaction(b, phase_events, step_flops, prev)
                prev = [b.barrier(ups, t)]
        (hop,) = [e for e in rest if e.hop == "es_to_es"]
        prev = [b.transfer(hop, prev)]
    return b.jobs


def _build_star(b, events, local_steps, flops1):
    """FedAvg: one E=K interaction against the PS, all clients parallel."""
    prev: list[int] = []
    for t in sorted(events):
        phases, rest = _in_cluster_phases(events[t])
        assert not rest, "FedAvg rounds are client<->PS only"
        step_flops = _steps_per_interaction(local_steps, len(phases)) * flops1
        for phase_events in phases:
            ups = _interaction(b, phase_events, step_flops, prev)
            prev = [b.barrier(ups, t)]
    return b.jobs


def _build_hier(b, events, local_steps, flops1):
    """Hier-Local-QSGD: per-cluster interaction chains in parallel, then the
    two-level ES->PS / PS->ES aggregation barrier."""
    prev: list[int] = []
    for t in sorted(events):
        phases, rest = _in_cluster_phases(events[t])
        step_flops = _steps_per_interaction(local_steps, len(phases)) * flops1
        # split each interaction phase by the aggregating ES
        cluster_prev: dict[str, list[int]] = defaultdict(lambda: list(prev))
        for phase_events in phases:
            per_es = defaultdict(list)
            for ev in phase_events:
                per_es[ev.sender if ev.hop == "es_to_client" else ev.receiver].append(ev)
            for es, evs in sorted(per_es.items()):
                ups = _interaction(b, evs, step_flops, cluster_prev[es])
                cluster_prev[es] = [b.barrier(ups, t)]
        es_up_events = sorted((e for e in rest if e.hop == "es_to_ps"),
                              key=lambda e: e.sender)
        es_ups = [b.transfer(ev, cluster_prev[ev.sender], fan_in=len(es_up_events))
                  for ev in es_up_events]
        ps_barrier = b.barrier(es_ups, t)
        downs = [b.transfer(ev, [ps_barrier])
                 for ev in sorted((e for e in rest if e.hop == "ps_to_es"),
                                  key=lambda e: e.receiver)]
        prev = [b.barrier(downs, t)]
    return b.jobs


def _build_walk(b, events, local_steps, flops1):
    """WRWGD: K local steps at the visited client, then one model hop."""
    prev: list[int] = []
    for t in sorted(events):
        (hop,) = events[t]
        c = b.compute(hop.sender, local_steps * flops1, t, prev)
        prev = [b.transfer(hop, [c])]
    return b.jobs


def replay_run(result, net: NetworkModel, *, local_steps: int, batch_size: int,
               num_params: int,
               deadline_s: float | None = None) -> tuple[list[Job], Timeline]:
    """Replay a recorded run through `net`: the job DAG AND its resolved
    timeline, from ONE compile.

    The pair is for consumers that need job-level detail (matching each
    `CommEvent` to the transfer job that carried it); callers that only
    want wall-clock aggregates can keep calling `timeline_for`."""
    b = _compile(result, net, local_steps=local_steps, batch_size=batch_size,
                 num_params=num_params, deadline_s=deadline_s)
    tl = simulate(b.jobs)
    tl.dropped = {r: frozenset(s) for r, s in b.dropped.items()}
    tl.dropped_bits = b.dropped_bits
    return b.jobs, tl


def timeline_for(result, net: NetworkModel, *, local_steps: int, batch_size: int,
                 num_params: int, deadline_s: float | None = None) -> Timeline:
    """Wall-clock timeline of a recorded run under `net`.

    `deadline_s` (default: `net.deadline_s`) switches on deadline dropouts;
    the timeline then reports who was dropped when (`Timeline.dropped`) and
    the uplink bits saved (`Timeline.dropped_bits`)."""
    _, tl = replay_run(result, net, local_steps=local_steps,
                       batch_size=batch_size, num_params=num_params,
                       deadline_s=deadline_s)
    return tl


def simulate_run(task, result, net: NetworkModel, *, local_steps: int,
                 deadline_s: float | None = None) -> Timeline:
    """`timeline_for` with batch size / model size pulled from the task."""
    return timeline_for(result, net, local_steps=local_steps,
                        batch_size=task.batch_size, num_params=task.num_params(),
                        deadline_s=deadline_s)


def time_to_accuracy(result, timeline: Timeline, gamma: float) -> float | None:
    """Seconds of simulated wall-clock until test accuracy first reaches
    `gamma` (None if the run never got there) — the timing analogue of
    `RunResult.bits_to_accuracy`."""
    r = result.rounds_to_accuracy(gamma)
    return None if r is None else timeline.time_until(r)
