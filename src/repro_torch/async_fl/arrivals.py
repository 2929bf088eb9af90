"""Arrival-event generation: netsim traces *drive* execution (copy of
`repro/async_fl/arrivals.py`).

The synchronous stack runs barrier rounds and lets `repro_torch.netsim` re-time
them after the fact (`adapters.replay_run`).  The async drivers invert that:
for every activation the dispatcher asks the availability trace who is up,
asks the `NetworkModel` how long each client's broadcast -> local-compute ->
upload chain takes, and the resulting *arrival times* decide what the
aggregator folds and when it fires.  Everything here is a pure function of
``(network seed, trace seed, ids, bits, activation)`` — no drawn state — so
a resumed run recomputes the exact timeline it was killed under (the
property the kill-and-resume parity tests pin).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.netsim.links import NetworkModel, sgd_step_flops
from repro_torch.part import AvailabilityTrace


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """One client's scheduled update: dispatched at `start`, update in
    flight until `arrival` (absolute simulated seconds)."""

    client: int
    cluster: int
    version: int       # model version (global fold count) it computes on
    start: float       # broadcast begins
    arrival: float     # upload fully received by the aggregator


def chain_arrival(
    network: NetworkModel,
    *,
    server: str,
    client: int,
    down_hop: str,
    up_hop: str,
    start: float,
    down_bits: int,
    up_bits: int,
    flops: float,
    round_idx: int,
    fan_in: int = 1,
) -> float:
    """Absolute arrival time of one broadcast -> compute -> upload chain."""
    c = f"client:{client}"
    t = start
    t += network.transfer_time(down_hop, server, c, down_bits,
                               round_idx=round_idx, phase=0)
    t += network.compute_time(c, flops, round_idx=round_idx)
    t += network.transfer_time(up_hop, c, server, up_bits,
                               round_idx=round_idx, phase=1, fan_in=fan_in)
    return t


def dispatch_cohort(
    network: NetworkModel,
    trace: AvailabilityTrace,
    *,
    server: str,
    cluster: int,
    members: list[int],
    version: int,
    start: float,
    down_bits: int,
    up_bits: int,
    num_params: int,
    batch_size: int,
    local_steps: int,
    down_hop: str = "es_to_client",
    up_hop: str = "client_to_es",
) -> list[Dispatch]:
    """Broadcast to every *available* member and schedule their arrivals.

    Availability is probed at (client, version): a device asleep when the
    model lands at its ES simply isn't dispatched this activation — it costs
    no draws, no bits, no waiting.  `fan_in` is the cohort size, so under
    `shared_ingress` the concurrent uploads split the server's bandwidth
    (the PS-bottleneck model the async PS baselines inherit)."""
    up = [i for i in members if trace.available(i, version)]
    flops = local_steps * sgd_step_flops(num_params, batch_size)
    return [
        Dispatch(
            client=i,
            cluster=cluster,
            version=version,
            start=start,
            arrival=chain_arrival(
                network, server=server, client=i, down_hop=down_hop,
                up_hop=up_hop, start=start, down_bits=down_bits,
                up_bits=up_bits, flops=flops, round_idx=version,
                fan_in=len(up),
            ),
        )
        for i in up
    ]


def fire_time(
    dispatches: list[Dispatch], *, quorum_frac: float, deadline_s: float | None,
    start: float,
) -> float:
    """When the aggregator stops waiting: the q-th arrival (q = ceil(frac *
    cohort)) capped by `start + deadline_s`.  An empty cohort fires at the
    deadline (or immediately without one) — the pass-through activation."""
    cap = float("inf") if deadline_s is None else start + deadline_s
    if not dispatches:
        return start if deadline_s is None else cap
    q = min(max(1, math.ceil(len(dispatches) * quorum_frac)), len(dispatches))
    arrivals = sorted(d.arrival for d in dispatches)
    return min(arrivals[q - 1], cap)
