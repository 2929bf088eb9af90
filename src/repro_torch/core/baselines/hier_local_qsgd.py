"""Hier-Local-QSGD (Liu et al., 2023a) baseline, classic 3-tier HFL with
quantized uplinks, the looped driver (port of
`repro/core/baselines/hier_local_qsgd.py`).

Per global round:
  * K/E edge aggregations: every cluster's clients run E local steps from
    the cluster model and the ES aggregates their channel-compressed
    deltas.  All M clusters advance together in the engine's
    `multi_cluster_round` over a padded (M, n_max) client grid.
  * Every ES then uploads its compressed cluster delta to the PS (one key
    per cluster, split per leaf inside the channel), which takes the
    D_{A,m}/D_A-weighted average and broadcasts it back.

Participation (`repro_torch.part`): `HierLocalQSGDConfig.sampler` picks
each cluster's reporters per round.  Dropouts fold into the engine's
masked (M, n_max) client slots (zero gamma, zero uplink bits, frozen
optimizer state); a cluster with no reporter makes its ES a pass-through:
zero delta, zero PS weight, no ES->PS upload, though it still receives the
PS broadcast.  A round with no reporter anywhere is skipped outright.

Client-held optimizer state lives in one (M, n_max)-stacked tree that
persists across rounds.  `scan_rounds=True` (the default, as in the
reference) runs the whole-run executor (`_hier_scan_plan`: per-round
gammas, masks, ES weights and both hops' keys precomputed, a captured CUDA
graph per round on the card); `scan_rounds=False` the looped driver.  Both
give the same params bit for bit and the same ledger.

`obs` (`repro_torch.obs.RunTelemetry`) traces the run's phases and, with
its taps on, records each trained round's per-cluster (M,) tele, in both
executors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.channels import Channel, DenseChannel, channel_wire_bits
from repro_torch.core.engine import (
    RoundEngine,
    ScanPlan,
    run_scan,
    scan_multi_body,
    uplink_keys,
)
from repro_torch.core.ledger import CommLedger
from repro_torch.core.precision import Precision, downlink_bits_per_param, resolve_channel
from repro_torch.core.prng import PRNGKey, split_chain, split_each
from repro_torch.core.simulation import FLTask, RunRecorder, RunResult
from repro_torch.data.sources import scatter_put, stage_chunk
from repro_torch.obs.trace import maybe_span
from repro_torch.optim.schedules import Schedule, paper_sqrt_schedule
from repro_torch.part import is_full_participation, participation_mask
from repro_torch.utils import tree_leaves

# reference config fields this port does not implement yet: setting one raises
_NOT_PORTED = ("mesh",)


@dataclasses.dataclass
class HierLocalQSGDConfig:
    rounds: int = 200
    local_steps: int = 20          # K in-cluster iterations per global round
    local_epochs: int = 5          # E (paper B.1: 5 local iterations per round)
    eval_every: int = 10
    bits_per_param: int = 32
    qsgd_levels: int | None = 16   # uplink quantization (client->ES and ES->PS)
    channel: Channel | None = None     # explicit client->ES channel
    es_channel: Channel | None = None  # explicit ES->PS channel (defaults to channel)
    local_opt: Any = None              # client-held optimizer (None = plain SGD)
    sampler: Any = None                # per-round participation (repro_torch.part);
                                       # None / FullParticipation = the unmasked path
    track_events: bool = True          # False: bits only, no CommEvent stream
    scan_rounds: bool = True           # whole-run executor (False: looped)
    chunk_rounds: int = 32             # rounds staged per chunk (scanned)
    seed: int = 0
    schedule: Schedule | None = None
    client_microbatch: int | None = None  # at most this many client replicas
                                          # train at once (None: all)
    precision: Precision | None = None    # mixed-precision policy
                                          # (core/precision.py)
    obs: Any = None                       # repro_torch.obs.RunTelemetry
    mesh: Any = None                      # not ported (see _NOT_PORTED)

    def __post_init__(self):
        unset = [f for f in _NOT_PORTED if getattr(self, f) is not None]
        if unset:
            raise NotImplementedError(
                f"HierLocalQSGDConfig fields not ported to repro_torch yet: {unset}")


def _participation_arrays(task: FLTask, parts_t, M: int, n_max: int):
    """One round's participation-renormalized (gammas, mask, sizes) rows as
    numpy: gamma rows renormalize over each cluster's reporters, and a
    cluster with none keeps an all-zero row (its ES is a pass-through)."""
    pmask = np.zeros((M, n_max), np.float32)
    gnp = np.zeros((M, n_max), np.float32)
    sizes = np.zeros(M, np.float32)
    for m, members in enumerate(task.cluster_members):
        row = participation_mask(members, parts_t[m])
        pmask[m, : len(members)] = row
        w = task.cluster_weights(m) * row
        if w.sum() > 0:
            gnp[m, : len(members)] = w / w.sum()
        sizes[m] = sum(task.client_sizes[i] for i in parts_t[m])
    return gnp, pmask, sizes


def run_hier_local_qsgd(task: FLTask, config: HierLocalQSGDConfig) -> RunResult:
    if config.scan_rounds:
        return _run_hier_scanned(task, config)
    task.reset_loaders(config.seed)
    assert config.local_steps % config.local_epochs == 0, "K must divide by E"
    K, E = config.local_steps, config.local_epochs
    interactions = K // E
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    lrs = np.array([sched_fn(k) for k in range(K)], dtype=np.float32)
    lrs_grouped = lrs.reshape(interactions, E)

    params = task.init_params()
    leaf_sizes = tuple(leaf.numel() for leaf in tree_leaves(params))
    d = sum(leaf_sizes)
    ledger = CommLedger(track_events=config.track_events)
    channel = resolve_channel(config.precision, config.channel, config.qsgd_levels,
                              config.bits_per_param)
    es_channel = config.es_channel if config.es_channel is not None else channel
    engine = RoundEngine(task.model, channel, es_channel, local_opt=config.local_opt,
                         client_microbatch=config.client_microbatch,
                         precision=config.precision)
    key = PRNGKey(config.seed + 1)
    lrs_t = engine.step_sizes(lrs_grouped, task.device)

    down_bits = DenseChannel(
        downlink_bits_per_param(config.precision, config.bits_per_param)).message_bits(d)
    up_bits = channel_wire_bits(channel, d, leaf_sizes)
    es_up_bits = channel_wire_bits(es_channel, d, leaf_sizes)

    M = task.num_clusters
    gammas, mask = task.padded_cluster_weights()
    sizes = np.array(task.cluster_sizes, dtype=np.float32)
    es_weights = torch.from_numpy(sizes / sizes.sum()).to(task.device)
    n_max = mask.shape[1]
    full_part = is_full_participation(config.sampler)
    opt_state = engine.init_opt_state(params, M, n_max)  # client-held, cross-round

    obs = config.obs
    taps = obs is not None and obs.taps
    recorder = RunRecorder(task, config.rounds, config.eval_every, obs=obs)
    losses = torch.full((1, 1), float("nan"))  # stays nan until a first trained round
    for t in range(config.rounds):
        if full_part:
            parts = list(task.cluster_members)
            gammas_t, mask_t, es_weights_t = gammas, mask, es_weights
            any_participants = True
        else:
            # per-cluster reporters -> masked (M, n_max) slots; ES weights
            # renormalize over the clusters that trained at all
            parts = [config.sampler.participants(t, members)
                     for members in task.cluster_members]
            gnp, pmask, sizes = _participation_arrays(task, parts, M, n_max)
            any_participants = sizes.sum() > 0
            if any_participants:
                gammas_t = torch.from_numpy(gnp).to(task.device)
                mask_t = torch.from_numpy(pmask).to(task.device)
                es_weights_t = torch.from_numpy(sizes / sizes.sum()).to(task.device)
        if not any_participants:
            # nobody anywhere: no draws, no keys, no traffic, params unchanged
            engine.end_round(ledger, t)
            recorder.record(t, params, losses)
            continue

        batch = task.sample_all_cluster_batches(K, E)  # (J, M, n_max, E, B, ...)
        subs = es_subs = None
        if channel.stochastic:
            key, flat = split_chain(key, interactions * M)
            subs = flat.reshape(interactions, M, 2)
        if es_channel.stochastic:
            key, es_subs = split_chain(key, M)
        with maybe_span(obs, "round"):
            out = engine.multi_cluster_round(
                params, batch, gammas_t, mask_t, es_weights_t, lrs_t, subs, es_subs,
                opt_state, taps=taps)
            params, opt_state, losses = out[:3]
        if taps:
            obs.record_round(t, out[3])
        if not full_part:
            # the loss over the clusters that trained (a dark one reads 0)
            losses = losses[:, torch.from_numpy(sizes > 0).to(losses.device)]

        if ledger.track_events:
            for j in range(interactions):
                for m in range(M):
                    for i in parts[m]:
                        ledger.record("es_to_client", down_bits, round=t, phase=j,
                                      sender=f"es:{m}", receiver=f"client:{i}")
                        ledger.record("client_to_es", up_bits, round=t, phase=j,
                                      sender=f"client:{i}", receiver=f"es:{m}")
            for m in range(M):
                if parts[m]:  # a pass-through ES uploads nothing
                    ledger.record("es_to_ps", es_up_bits, round=t, phase=interactions,
                                  sender=f"es:{m}", receiver="ps")
                # every ES still receives the broadcast, to stay in sync
                ledger.record("ps_to_es", down_bits, round=t, phase=interactions + 1,
                              sender="ps", receiver=f"es:{m}")
        else:
            n_part = sum(len(p) for p in parts)
            ledger.record("es_to_client", down_bits, interactions * n_part)
            ledger.record("client_to_es", up_bits, interactions * n_part)
            ledger.record("es_to_ps", es_up_bits, sum(1 for p in parts if p))
            ledger.record("ps_to_es", down_bits, M)
        engine.end_round(ledger, t)
        recorder.record(t, params, losses)

    return recorder.result("hier_local_qsgd", ledger, params)


# --------------------------------------------------------------------------
# the whole-run executor's plan: per-round (gammas, mask, ES weights) and
# both hops' keys precomputed, batches staged a chunk of global rounds at a
# time; all-dark rounds are skipped and the ledger rebuilt after the run.
# The looped driver already runs the padded, masked multi-cluster round, so
# the body is the very same computation.
# --------------------------------------------------------------------------


def _hier_scan_plan(task: FLTask, source, config: HierLocalQSGDConfig):
    """Whole-run `ScanPlan` + deferred glue.  Returns (plan, params_of,
    traffic, sel_of): `sel_of(t)` is the boolean cluster selector the
    looped driver applies to round t's (J, M) loss grid before logging
    (None under full participation)."""
    source.reset(config.seed)
    assert config.local_steps % config.local_epochs == 0, "K must divide by E"
    K, E = config.local_steps, config.local_epochs
    interactions = K // E
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    lrs = np.asarray([sched_fn(k) for k in range(K)], dtype=np.float32)

    params = task.init_params()
    leaf_sizes = tuple(leaf.numel() for leaf in tree_leaves(params))
    d = sum(leaf_sizes)
    channel = resolve_channel(config.precision, config.channel, config.qsgd_levels,
                              config.bits_per_param)
    es_channel = config.es_channel if config.es_channel is not None else channel
    engine = RoundEngine(task.model, channel, es_channel, local_opt=config.local_opt,
                         client_microbatch=config.client_microbatch,
                         precision=config.precision)

    M = task.num_clusters
    members_of = task.cluster_members
    n_max = max(len(m) for m in members_of)
    sizes_full = np.array(task.cluster_sizes, dtype=np.float32)
    full_part = is_full_participation(config.sampler)

    R = config.rounds
    parts = [
        [list(m) for m in members_of] if full_part
        else [config.sampler.participants(t, m) for m in members_of]
        for t in range(R)
    ]
    gammas_r = np.zeros((R, M, n_max), np.float32)
    mask_r = np.zeros((R, M, n_max), np.float32)
    esw_r = np.zeros((R, M), np.float32)
    sizes_r = np.zeros((R, M), np.float32)
    trained = np.zeros(R, bool)
    for t in range(R):
        if full_part:  # the looped driver's `padded_cluster_weights`
            for m, members in enumerate(members_of):
                gammas_r[t, m, : len(members)] = task.cluster_weights(m)
                mask_r[t, m, : len(members)] = 1.0
            esw_r[t] = sizes_full / sizes_full.sum()
            trained[t] = True
        else:
            gammas_r[t], mask_r[t], sizes_r[t] = _participation_arrays(task, parts[t], M, n_max)
            trained[t] = sizes_r[t].sum() > 0
            if trained[t]:
                esw_r[t] = sizes_r[t] / sizes_r[t].sum()

    # keys: per trained round the looped driver splits J*M uplink keys, then
    # M ES keys (each only for a stochastic channel); one chain draws both
    subs_r = np.zeros((R, interactions, M, 2), np.uint32)
    es_subs_r = np.zeros((R, M, 2), np.uint32)
    per_round = (interactions * M if channel.stochastic else 0) + (
        M if es_channel.stochastic else 0)
    n_tr = int(trained.sum())
    if n_tr and per_round:
        _, flat = split_chain(PRNGKey(config.seed + 1), n_tr * per_round)
        flat = flat.reshape(n_tr, per_round, 2)
        ofs = 0
        if channel.stochastic:
            subs_r[trained] = flat[:, : interactions * M].reshape(n_tr, interactions, M, 2)
            ofs = interactions * M
        if es_channel.stochastic:
            es_subs_r[trained] = flat[:, ofs: ofs + M]
    width = engine.key_width(n_max)
    n_leaves = len(leaf_sizes)

    def stage(idxs):
        C = len(idxs)
        cs = list(range(C))  # every trained round stages every cluster
        batch = stage_chunk(
            source,
            [(client, K * C,
              scatter_put((cs, slice(None), m, slot),
                          lambda dl: dl.reshape(C, interactions, E, *dl.shape[1:])))
             for m, members in enumerate(members_of)
             for slot, client in enumerate(members)],
            lambda a: (C, interactions, M, n_max, E) + a.shape[1:],
        )
        for m, members in enumerate(members_of):
            if len(members) < n_max:  # padded slots replicate member 0
                for bl in tree_leaves(batch):
                    bl[cs, :, m, len(members):] = bl[cs, :, m, 0:1]
        xs = {"batch": batch, "gammas": gammas_r[idxs], "mask": mask_r[idxs],
              "es_weights": esw_r[idxs], "subs": subs_r[idxs], "es_subs": es_subs_r[idxs]}
        if channel.stochastic and channel.per_message:
            xs["keys"] = uplink_keys(subs_r[idxs], width, n_leaves)
        if es_channel.stochastic:
            xs["es_keys"] = split_each(es_subs_r[idxs], n_leaves)
        return xs

    plan = ScanPlan(
        body=scan_multi_body(engine.model, channel, es_channel, engine.local_opt,
                             config.client_microbatch, config.precision,
                             config.obs is not None and config.obs.taps),
        carry=(params, engine.init_opt_state(params, M, n_max)),
        consts={"lrs": engine.step_sizes(lrs.reshape(interactions, E), task.device)},
        stage=stage, trained=trained, rounds=R, eval_every=config.eval_every,
        chunk_rounds=config.chunk_rounds, obs=config.obs,
    )

    down_bits = DenseChannel(
        downlink_bits_per_param(config.precision, config.bits_per_param)).message_bits(d)
    up_bits = channel_wire_bits(channel, d, leaf_sizes)
    es_up_bits = channel_wire_bits(es_channel, d, leaf_sizes)

    def traffic(track_events: bool):
        for t in range(R):
            entries = []
            if trained[t]:
                if track_events:
                    for j in range(interactions):
                        for m in range(M):
                            es = f"es:{m}"
                            for i in parts[t][m]:
                                entries.append(("es_to_client", down_bits, 1, j, es,
                                                f"client:{i}"))
                                entries.append(("client_to_es", up_bits, 1, j,
                                                f"client:{i}", es))
                    for m in range(M):
                        if parts[t][m]:  # a pass-through ES uploads nothing
                            entries.append(("es_to_ps", es_up_bits, 1, interactions,
                                            f"es:{m}", "ps"))
                        # every ES still receives the broadcast, to stay in sync
                        entries.append(("ps_to_es", down_bits, 1, interactions + 1,
                                        "ps", f"es:{m}"))
                else:
                    n_part = sum(len(p) for p in parts[t])
                    entries.append(("es_to_client", down_bits, interactions * n_part, 0,
                                    None, None))
                    entries.append(("client_to_es", up_bits, interactions * n_part, 0,
                                    None, None))
                    entries.append(("es_to_ps", es_up_bits, sum(1 for p in parts[t] if p), 0,
                                    None, None))
                    entries.append(("ps_to_es", down_bits, M, 0, None, None))
            yield t, entries

    def sel_of(t: int):
        return None if full_part else sizes_r[t] > 0

    return plan, (lambda c: c[0]), traffic, sel_of


def _run_hier_scanned(task: FLTask, config: HierLocalQSGDConfig) -> RunResult:
    obs = config.obs
    with maybe_span(obs, "precompute"):
        plan, params_of, traffic, sel_of = _hier_scan_plan(task, task.source, config)
    recorder = RunRecorder(task, config.rounds, config.eval_every, obs=obs)

    def record(t, carry, losses, last_t):
        if losses is not None:
            sel = sel_of(last_t)
            if sel is not None:
                # the looped driver logs the mean over the clusters that
                # trained in the last trained round
                losses = losses[:, torch.from_numpy(sel).to(losses.device)]
        recorder.record(t, params_of(carry), losses)

    carry = run_scan(plan, record)
    ledger = CommLedger(track_events=config.track_events)
    with maybe_span(obs, "materialize"):
        ledger.materialize(traffic(config.track_events))
    return recorder.result("hier_local_qsgd", ledger, params_of(carry))
