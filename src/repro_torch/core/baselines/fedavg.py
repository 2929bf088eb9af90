"""FedAvg (McMahan et al., 2017) baseline, the looped driver (port of
`repro/core/baselines/fedavg.py`).

Per round: every client runs K local optimizer steps from the PS model,
uploads its channel-compressed model delta to the PS (the ledger records
the client<->PS hop types, so the structural comparison of the paper's
Fig. 2 is visible), and the PS takes the D_n/D_A-weighted average.  A
FedAvg round is one engine interaction with E = K over all n clients.
Client-held optimizer state persists across rounds without traversing the
channel.

Participation (`repro_torch.part`): `FedAvgConfig.sampler` picks the
reporting subset each round.  Dropped clients send nothing, keep their
optimizer state frozen, and the D_n weights renormalize over the
reporters.  A round with no reporter is skipped outright.

`scan_rounds=True` (the default, as in the reference) runs the whole-run
executor (`_fedavg_scan_plan`, `engine.run_scan`: a captured CUDA graph
per round on the card); `scan_rounds=False` the looped driver.  Both give
the same params bit for bit and the same ledger.

`obs` (`repro_torch.obs.RunTelemetry`) traces the run's phases and, with
its taps on, records each trained round's tele, in both executors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.channels import Channel, DenseChannel, channel_wire_bits
from repro_torch.core.engine import RoundEngine, ScanPlan, run_scan, scan_delta_body, uplink_keys
from repro_torch.core.ledger import CommLedger
from repro_torch.core.precision import Precision, downlink_bits_per_param, resolve_channel
from repro_torch.core.prng import PRNGKey, split_chain
from repro_torch.core.simulation import FLTask, RunRecorder, RunResult
from repro_torch.data.sources import scatter_put, stage_chunk
from repro_torch.obs.trace import maybe_span
from repro_torch.optim.schedules import Schedule, paper_sqrt_schedule
from repro_torch.part import (
    is_full_participation,
    participation_mask,
    schedule_participants,
    stack_masks,
)
from repro_torch.sharding.fed import resolve_mesh, shard_plan
from repro_torch.utils import tree_leaves


@dataclasses.dataclass
class FedAvgConfig:
    rounds: int = 200
    local_steps: int = 20          # paper B.1: "training epochs in clients ... K=20"
    eval_every: int = 10
    bits_per_param: int = 32
    qsgd_levels: int | None = None
    channel: Channel | None = None  # explicit uplink channel
    local_opt: Any = None           # client-held optimizer (None = plain SGD)
    sampler: Any = None             # per-round participation (repro_torch.part);
                                    # None / FullParticipation = the unmasked path
    track_events: bool = True       # False: bits only, no CommEvent stream
    scan_rounds: bool = True        # whole-run executor (False: looped)
    chunk_rounds: int = 32          # rounds staged per chunk (scanned)
    seed: int = 0
    schedule: Schedule | None = None
    client_microbatch: int | None = None  # at most this many client replicas
                                          # train at once (None: all)
    precision: Precision | None = None    # mixed-precision policy
                                          # (core/precision.py)
    obs: Any = None                       # repro_torch.obs.RunTelemetry
    mesh: Any = None                      # launch.mesh.FederationMesh: the client
                                          # axis over its ranks (sharding.fed);
                                          # None adopts an ambient one


def run_fedavg(task: FLTask, config: FedAvgConfig) -> RunResult:
    if config.scan_rounds:
        return _run_fedavg_scanned(task, config)
    task.reset_loaders(config.seed)
    K = config.local_steps
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    lrs = np.array([[sched_fn(k) for k in range(K)]], dtype=np.float32)  # (1, K)

    params = task.init_params()
    leaf_sizes = tuple(leaf.numel() for leaf in tree_leaves(params))
    d = sum(leaf_sizes)
    ledger = CommLedger(track_events=config.track_events)
    channel = resolve_channel(config.precision, config.channel, config.qsgd_levels,
                              config.bits_per_param)
    engine = RoundEngine(task.model, channel, local_opt=config.local_opt,
                         client_microbatch=config.client_microbatch,
                         precision=config.precision)
    gammas = torch.from_numpy(task.global_weights()).to(task.device)
    key = PRNGKey(config.seed + 1)
    lrs_t = engine.step_sizes(lrs, task.device)

    down_bits = DenseChannel(
        downlink_bits_per_param(config.precision, config.bits_per_param)).message_bits(d)
    up_bits = channel_wire_bits(channel, d, leaf_sizes)

    obs = config.obs
    taps = obs is not None and obs.taps
    recorder = RunRecorder(task, config.rounds, config.eval_every, obs=obs)
    n = task.num_clients
    full_part = is_full_participation(config.sampler)
    all_clients = list(range(n))
    opt_state = engine.init_opt_state(params, n)  # client-held, cross-round
    losses = torch.full((1,), float("nan"))  # stays nan until a first trained round
    for t in range(config.rounds):
        participating = (
            all_clients if full_part else config.sampler.participants(t, all_clients))
        if participating:
            # every client stages its K batches, client by client, at full
            # width even under churn: one E = K interaction, leaves
            # (1, n, K, B, ...)
            per_client = [task.sample_client_batches(i, K) for i in range(n)]
            batch = {k: torch.stack([b[k] for b in per_client])[None] for k in per_client[0]}
            subs = None
            if channel.stochastic:
                key, subs = split_chain(key, 1)
            gammas_t, pmask = gammas, None
            if not full_part:
                # D_n weights renormalized over the reporters on the host
                pmask = participation_mask(all_clients, participating)
                w = task.global_weights() * pmask
                gammas_t = torch.from_numpy((w / w.sum()).astype(np.float32)).to(task.device)
                pmask = torch.from_numpy(pmask).to(task.device)
            with maybe_span(obs, "round"):
                out = engine.cluster_round(params, batch, gammas_t, lrs_t, subs, opt_state,
                                           mask=pmask, taps=taps)
                params, opt_state, losses = out[:3]
            if taps:
                obs.record_round(t, out[3])

            if ledger.track_events:
                for i in participating:
                    ledger.record("ps_to_client", down_bits, round=t, phase=0,
                                  sender="ps", receiver=f"client:{i}")
                    ledger.record("client_to_ps", up_bits, round=t, phase=0,
                                  sender=f"client:{i}", receiver="ps")
            else:
                ledger.record("ps_to_client", down_bits, len(participating))
                ledger.record("client_to_ps", up_bits, len(participating))
        # else: nobody reported, and the round is skipped outright (no
        # draws, no keys, no traffic, params unchanged)
        engine.end_round(ledger, t)
        recorder.record(t, params, losses)

    return recorder.result("fedavg", ledger, params)


# --------------------------------------------------------------------------
# the whole-run executor's plan
# --------------------------------------------------------------------------


def _fedavg_scan_plan(task: FLTask, source, config: FedAvgConfig):
    """Whole-run `ScanPlan` + deferred glue (see `fed_chs._fed_chs_scan_plan`)."""
    source.reset(config.seed)
    K = config.local_steps
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    lrs = np.asarray([[sched_fn(k) for k in range(K)]], dtype=np.float32)  # (1, K)

    params = task.init_params()
    leaf_sizes = tuple(leaf.numel() for leaf in tree_leaves(params))
    d = sum(leaf_sizes)
    channel = resolve_channel(config.precision, config.channel, config.qsgd_levels,
                              config.bits_per_param)
    engine = RoundEngine(task.model, channel, local_opt=config.local_opt,
                         client_microbatch=config.client_microbatch,
                         precision=config.precision)

    R = config.rounds
    n = task.num_clients
    full_part = is_full_participation(config.sampler)
    all_clients = list(range(n))
    parts = schedule_participants(config.sampler, R, all_clients)
    trained = np.array([len(p) > 0 for p in parts])

    mask_r = stack_masks(all_clients, parts)
    gammas_r = np.zeros((R, n), np.float32)
    gw = task.global_weights()
    for t in np.flatnonzero(trained):
        if full_part:
            gammas_r[t] = gw
        else:
            w = gw * mask_r[t]
            gammas_r[t] = (w / w.sum()).astype(np.float32)

    subs_r = np.zeros((R, 1, 2), np.uint32)
    if channel.stochastic:
        n_tr = int(trained.sum())
        if n_tr:
            _, flat = split_chain(PRNGKey(config.seed + 1), n_tr)
            subs_r[trained] = flat.reshape(n_tr, 1, 2)
    keyed = channel.stochastic and channel.per_message
    width = engine.key_width(n)

    def stage(idxs):
        C = len(idxs)
        cs = list(range(C))  # every trained round stages every client
        batch = stage_chunk(
            source,
            [(i, K * C, scatter_put((cs, 0, i), lambda dl: dl.reshape(C, K, *dl.shape[1:])))
             for i in range(n)],
            lambda a: (C, 1, n, K) + a.shape[1:],
        )
        xs = {"batch": batch, "gammas": gammas_r[idxs], "mask": mask_r[idxs],
              "subs": subs_r[idxs]}
        if keyed:
            xs["keys"] = uplink_keys(subs_r[idxs], width, len(leaf_sizes))
        return xs

    taps = config.obs is not None and config.obs.taps
    plan = ScanPlan(
        body=scan_delta_body(engine.model, channel, engine.local_opt,
                             config.client_microbatch, config.precision, taps),
        carry=(params, engine.init_opt_state(params, n)),
        consts={"lrs": engine.step_sizes(lrs, task.device)},
        stage=stage, trained=trained, rounds=R, eval_every=config.eval_every,
        chunk_rounds=config.chunk_rounds, obs=config.obs,
    )
    mesh = resolve_mesh(config.mesh)
    if mesh is not None:
        assert config.client_microbatch is None, \
            "client_microbatch and a federation mesh are mutually exclusive"
        plan = shard_plan(plan, mesh, "delta", model=engine.model, channel=channel,
                          opt=engine.local_opt, clients=n, lrs=lrs)

    down_bits = DenseChannel(
        downlink_bits_per_param(config.precision, config.bits_per_param)).message_bits(d)
    up_bits = channel_wire_bits(channel, d, leaf_sizes)

    def traffic(track_events: bool):
        for t in range(R):
            entries = []
            p = parts[t]
            if p:
                if track_events:
                    for i in p:
                        entries.append(("ps_to_client", down_bits, 1, 0, "ps", f"client:{i}"))
                        entries.append(("client_to_ps", up_bits, 1, 0, f"client:{i}", "ps"))
                else:
                    entries.append(("ps_to_client", down_bits, len(p), 0, None, None))
                    entries.append(("client_to_ps", up_bits, len(p), 0, None, None))
            yield t, entries

    return plan, (lambda c: c[0]), traffic


def _run_fedavg_scanned(task: FLTask, config: FedAvgConfig) -> RunResult:
    obs = config.obs
    with maybe_span(obs, "precompute"):
        plan, params_of, traffic = _fedavg_scan_plan(task, task.source, config)
    recorder = RunRecorder(task, config.rounds, config.eval_every, obs=obs)
    carry = run_scan(plan, lambda t, c, losses, _lt: recorder.record(t, params_of(c), losses))
    ledger = CommLedger(track_events=config.track_events)
    with maybe_span(obs, "materialize"):
        ledger.materialize(traffic(config.track_events))
    return recorder.result("fedavg", ledger, params_of(carry))
