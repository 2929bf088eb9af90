"""Classic async parameter-server baselines: FedBuff FedAvg + two-tier Hier
(port of `repro/async_fl/ps.py`).

These give the event-driven Fed-CHS chain its comparison arms:

  * `run_async_fedavg` — one PS, FedBuff aggregation: clients continuously
    compute on whatever model version they last received; the PS buffers
    arriving updates and folds every `quorum_k` of them with
    staleness-discounted weights, then re-dispatches the folded clients.
  * `run_async_hier` — the 3-tier analogue: each ES runs a FedBuff over its
    cluster (wireless hops), and every ES-level fold is pushed to the PS
    over the WAN, folded FedAsync-style (immediately, staleness-discounted)
    into the global model, which returns to that ES for its next cohort.

Both share the Fed-CHS driver's computations (`compute.client_updates_fn`,
`compute.fold_fn`) and the netsim arrival machinery: same local step, same
channel accounting, same physical network, same availability churn.  The
arrival heap's order, the dispatch waves and the re-probes of churned-out
clients are the reference's, so the ledger, the staleness histogram and
the simulated clock equal the reference's.  PS-variant folds renormalize
their weights to unit mass by default (the FedBuff convention).  Every
update in flight holds a delta of its own (a clone of its cohort's row).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any

import numpy as np
import torch

from repro_torch.async_fl.arrivals import chain_arrival
from repro_torch.async_fl.buffer import StalenessBuffer, Update, staleness_weight
from repro_torch.async_fl.compute import client_updates_fn, fold_fn, no_subs, stack_updates
from repro_torch.async_fl.fed_chs import (
    init_opt_rows,
    own_storage,
    put_rows,
    stage_clients,
    take_rows,
)
from repro_torch.comm.channels import Channel, DenseChannel, channel_wire_bits, make_channel
from repro_torch.core.ledger import CommLedger
from repro_torch.core.prng import PRNGKey, split_chain
from repro_torch.core.simulation import FLTask, RunRecorder, RunResult
from repro_torch.netsim.links import NetworkModel, edge_cloud_network, sgd_step_flops
from repro_torch.optim.local import PlainSGD
from repro_torch.optim.schedules import Schedule, paper_sqrt_schedule
from repro_torch.part import AlwaysOn, AvailabilityTrace
from repro_torch.utils import tree_map

Tree = Any
PyTree = Tree  # the reference's name


@dataclasses.dataclass
class AsyncPSConfig:
    rounds: int = 60                       # PS folds
    local_steps: int = 10
    quorum_k: int = 4                      # buffer size that triggers a fold
    staleness_alpha: float = 0.5
    max_staleness: int | None = 8
    renormalize: bool = True               # FedBuff convention: unit-mass folds
    server_lr: float = 1.0                 # scale on each folded aggregate
    network: NetworkModel | None = None
    trace: AvailabilityTrace | None = None
    eval_every: int = 10
    bits_per_param: int = 32
    qsgd_levels: int | None = None
    channel: Channel | None = None
    local_opt: Any = None                  # client-held optimizer; None = PlainSGD
    track_events: bool = True
    seed: int = 0
    schedule: Schedule | None = None


def _common(task: FLTask, config: AsyncPSConfig):
    network = config.network or edge_cloud_network()
    trace = config.trace or AlwaysOn()
    channel = (config.channel if config.channel is not None
               else make_channel(config.qsgd_levels, config.bits_per_param))
    opt = config.local_opt or PlainSGD()
    K = config.local_steps
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    lrs = torch.as_tensor(np.asarray([sched_fn(k) for k in range(K)], np.float32),
                          device=task.device)
    d = task.num_params()
    down_bits = DenseChannel(config.bits_per_param).message_bits(d)
    up_bits = channel_wire_bits(channel, d, task.param_leaf_sizes())
    return network, trace, channel, opt, lrs, d, down_bits, up_bits


def _fold_weights(folded: list[Update], version: int, config: AsyncPSConfig,
                  device) -> torch.Tensor:
    w = np.asarray([staleness_weight(u.gamma, version - u.version, config.staleness_alpha)
                    for u in folded], np.float32)
    if config.renormalize:
        w = w / w.sum()
    return torch.as_tensor(config.server_lr * w, device=device)


def run_async_fedavg(task: FLTask, config: AsyncPSConfig) -> RunResult:
    """Single-PS FedBuff: fold every `quorum_k` arrivals, redispatch."""
    network, trace, channel, opt, lrs, d, down_bits, up_bits = _common(task, config)
    updates = client_updates_fn(task.fed_model, channel, opt)
    fold = fold_fn(task.fed_model)
    task.reset_loaders(config.seed)

    params = task.init_params()
    N = task.num_clients
    gammas = task.global_weights()
    opt_state = None
    key = PRNGKey(config.seed + 1)
    ledger = CommLedger(track_events=config.track_events)
    recorder = RunRecorder(task, config.rounds, config.eval_every)
    sim_eval_times: list[float] = []
    flops = config.local_steps * sgd_step_flops(d, task.batch_size)

    heap: list[tuple[float, int, Update]] = []   # (arrival, client, update)
    buf = StalenessBuffer(max_staleness=config.max_staleness)
    idle = list(range(N))
    version, wave, now = 0, 0, 0.0
    losses = None

    def dispatch(now: float):
        """Send the current model to every idle+available client; their
        updates (computed on `params` at `version`) enter the arrival heap."""
        nonlocal idle, opt_state, key, losses
        up = [i for i in idle if trace.available(i, wave)]
        if not up:
            return
        idle = [i for i in idle if i not in up]
        batch = stage_clients(task, up, config.local_steps)
        if opt_state is None:
            opt_state = init_opt_rows(opt, params, N)
        idx = torch.as_tensor(up, dtype=torch.long, device=task.device)
        sub = no_subs()
        if channel.stochastic:
            key, subs = split_chain(key, 1)
            sub = subs[0]
        deltas, new_opt, ls = updates(params, take_rows(opt_state, idx), batch, lrs, sub)
        put_rows(opt_state, idx, new_opt)
        losses = ls
        for j, i in enumerate(up):
            arrival = chain_arrival(
                network, server="ps", client=i, down_hop="ps_to_client",
                up_hop="client_to_ps", start=now, down_bits=down_bits,
                up_bits=up_bits, flops=flops, round_idx=wave, fan_in=len(up))
            ledger.record("ps_to_client", down_bits, round=version, phase=0,
                          sender="ps", receiver=f"client:{i}")
            heapq.heappush(heap, (arrival, i, own_storage(Update(
                client=i, cluster=0, version=version, arrival=arrival,
                gamma=float(gammas[i]), delta=tree_map(lambda leaf, j=j: leaf[j], deltas)))))

    dispatch(now)
    for v in range(config.rounds):
        # drain arrivals until the buffer hits quorum (or nothing is left
        # in flight — then fold what we have; re-probe churned-out clients)
        while len(buf) < config.quorum_k:
            if not heap:
                if len(buf) > 0:
                    break
                wave += 1
                dispatch(now)
                if not heap:
                    wave += 1
                    continue
            t, _, u = heapq.heappop(heap)
            now = max(now, t)
            buf.add(u)

        for u in buf.evict_stale(version):
            ledger.record("client_to_ps", up_bits, round=version, phase=1,
                          sender=f"client:{u.client}", receiver="ps",
                          staleness=version - u.version)
        folded = buf.take()
        if folded:
            w = _fold_weights(folded, version, config, task.device)
            params = fold(params, stack_updates([u.delta for u in folded]), w)
            for u in folded:
                ledger.record("client_to_ps", up_bits, round=version, phase=1,
                              sender=f"client:{u.client}", receiver="ps",
                              staleness=version - u.version)
            idle.extend(sorted(u.client for u in folded))
        version += 1
        wave += 1
        ledger.snapshot(v)
        if recorder.should_eval(v):
            sim_eval_times.append(now)
        recorder.record(v, params, losses)
        dispatch(now)

    res = recorder.result("async_fedavg", ledger, params)
    return dataclasses.replace(res, sim_times=sim_eval_times)


def run_async_hier(task: FLTask, config: AsyncPSConfig) -> RunResult:
    """Two-tier async HFL: per-ES FedBuff + FedAsync ES->PS folds.

    Each ES keeps its own model copy (the PS model it last received, tagged
    with the PS version) and runs a FedBuff over its cluster; every
    `quorum_k`-sized ES fold produces one aggregated cluster delta that
    rides the WAN to the PS, folds immediately (staleness = PS folds since
    that ES last synced), and the refreshed global model returns to the ES.
    """
    network, trace, channel, opt, lrs, d, down_bits, up_bits = _common(task, config)
    updates = client_updates_fn(task.fed_model, channel, opt)
    fold = fold_fn(task.fed_model)
    task.reset_loaders(config.seed)

    params = task.init_params()          # PS model
    M = task.num_clusters
    key = PRNGKey(config.seed + 1)
    ledger = CommLedger(track_events=config.track_events)
    recorder = RunRecorder(task, config.rounds, config.eval_every)
    sim_eval_times: list[float] = []
    flops = config.local_steps * sgd_step_flops(d, task.batch_size)

    es_model = [params for _ in range(M)]
    es_version = [0] * M                  # PS version each ES's model carries
    es_buf = [StalenessBuffer(max_staleness=config.max_staleness) for _ in range(M)]
    es_folds = [0] * M                    # local fold counter per ES
    opt_states: dict[int, Tree] = {}
    idle = {m: list(task.cluster_members[m]) for m in range(M)}
    heap: list[tuple[float, int, int, Update]] = []  # (arrival, m, client, u)
    ps_version, wave, now = 0, 0, 0.0
    losses = None

    def dispatch(m: int, now: float):
        nonlocal key, losses
        members = task.cluster_members[m]
        up = [i for i in idle[m] if trace.available(i, wave)]
        if not up:
            return
        idle[m] = [i for i in idle[m] if i not in up]
        gammas = task.cluster_weights(m)
        slots = [members.index(i) for i in up]
        batch = stage_clients(task, up, config.local_steps)
        if m not in opt_states:
            opt_states[m] = init_opt_rows(opt, es_model[m], len(members))
        idx = torch.as_tensor(slots, dtype=torch.long, device=task.device)
        sub = no_subs()
        if channel.stochastic:
            key, subs = split_chain(key, 1)
            sub = subs[0]
        deltas, new_opt, ls = updates(es_model[m], take_rows(opt_states[m], idx), batch,
                                      lrs, sub)
        put_rows(opt_states[m], idx, new_opt)
        losses = ls
        for j, i in enumerate(up):
            arrival = chain_arrival(
                network, server=f"es:{m}", client=i, down_hop="es_to_client",
                up_hop="client_to_es", start=now, down_bits=down_bits,
                up_bits=up_bits, flops=flops, round_idx=wave, fan_in=len(up))
            ledger.record("es_to_client", down_bits, round=ps_version, phase=0,
                          sender=f"es:{m}", receiver=f"client:{i}")
            heapq.heappush(heap, (arrival, m, i, own_storage(Update(
                client=i, cluster=m, version=es_folds[m], arrival=arrival,
                gamma=float(gammas[slots[j]]),
                delta=tree_map(lambda leaf, j=j: leaf[j], deltas)))))

    for m in range(M):
        dispatch(m, now)

    for v in range(config.rounds):
        # advance client arrivals until some ES reaches its quorum
        fired_m = None
        while fired_m is None:
            if not heap:
                wave += 1
                ready = [m for m in range(M) if len(es_buf[m]) > 0]
                if ready:
                    fired_m = min(ready, key=lambda m: -len(es_buf[m]))
                    break
                for m in range(M):
                    dispatch(m, now)
                if not heap:
                    continue
            t, m, _, u = heapq.heappop(heap)
            now = max(now, t)
            es_buf[m].add(u)
            if len(es_buf[m]) >= config.quorum_k:
                fired_m = m
        m = fired_m

        for u in es_buf[m].evict_stale(es_folds[m]):
            ledger.record("client_to_es", up_bits, round=ps_version, phase=1,
                          sender=f"client:{u.client}", receiver=f"es:{m}",
                          staleness=es_folds[m] - u.version)
        folded = es_buf[m].take()
        if folded:
            w = np.asarray([staleness_weight(u.gamma, es_folds[m] - u.version,
                                             config.staleness_alpha) for u in folded],
                           np.float32)
            if config.renormalize:
                w = w / w.sum()
            w_t = torch.as_tensor(w, device=task.device)
            cluster_delta = tree_map(lambda dl: torch.tensordot(w_t.to(dl.dtype), dl, dims=1),
                                     stack_updates([u.delta for u in folded]))
            for u in folded:
                ledger.record("client_to_es", up_bits, round=ps_version, phase=1,
                              sender=f"client:{u.client}", receiver=f"es:{m}",
                              staleness=es_folds[m] - u.version)
            idle[m].extend(sorted(u.client for u in folded))
            es_folds[m] += 1

            # ES -> PS (WAN), FedAsync: fold on arrival with PS staleness
            now += network.transfer_time("es_to_ps", f"es:{m}", "ps", up_bits,
                                         round_idx=ps_version, phase=2)
            tau_ps = ps_version - es_version[m]
            w_ps = staleness_weight(1.0, tau_ps, config.staleness_alpha)
            params = fold(params, tree_map(lambda leaf: leaf[None], cluster_delta),
                          torch.as_tensor(np.asarray([config.server_lr * w_ps], np.float32),
                                          device=task.device))
            ledger.record("es_to_ps", up_bits, round=ps_version, phase=2,
                          sender=f"es:{m}", receiver="ps", staleness=tau_ps)
            # PS -> ES: the refreshed model returns; the ES adopts it
            now += network.transfer_time("ps_to_es", "ps", f"es:{m}", down_bits,
                                         round_idx=ps_version, phase=3)
            ledger.record("ps_to_es", down_bits, round=ps_version, phase=3,
                          sender="ps", receiver=f"es:{m}")
            ps_version += 1
            es_model[m] = params
            es_version[m] = ps_version
        wave += 1
        ledger.snapshot(v)
        if recorder.should_eval(v):
            sim_eval_times.append(now)
        recorder.record(v, params, losses)
        dispatch(m, now)

    res = recorder.result("async_hier", ledger, params)
    return dataclasses.replace(res, sim_times=sim_eval_times)
