"""Fed-CHS (Algorithm 1), the looped driver (port of `repro/core/fed_chs.py`).

Round t:
  1. ES m(t) broadcasts w^t to its cluster's clients.
  2. K/E interactions: clients run E local steps from the broadcast model
     (E=1 + plain SGD + a dense channel is Eq. (5) literally, the grad-mode
     round), upload their update through the channel, and the ES adds the
     gamma-weighted aggregate.
  3. m(t) selects m(t+1) by the 2-step least-traversed / largest-dataset
     rule and pushes w^{t+1} over one ES->ES hop.  No PS anywhere.

Every message is metered in the `CommLedger` with its (round, phase,
sender, receiver) event, exactly as the reference records it.  Grad mode
and delta mode run with any of the reference's uplink channels and
client-held optimizers.

Two executors, as in the reference.  `scan_rounds=True` (the default) runs
the whole-run executor (`engine.run_scan`): the visit order, masks, gammas
and keys are precomputed on the host (`_fed_chs_scan_plan`), batches are
staged `chunk_rounds` rounds at a time, and on the card every round after
the first replays one captured CUDA graph; the ledger is materialized from
the schedule after the run.  `scan_rounds=False` is the looped driver, one
round at a time from Python.  Both give the same params bit for bit, the
same eval metrics and the same ledger.

Participation (`repro_torch.part`): `FedCHSConfig.sampler` decides which
of the active cluster's clients report each round.  Participants run the
masked engine round (gammas renormalized over them, frozen optimizer state
for everyone else); a cluster whose clients are all unavailable becomes a
pass-through hop that forwards the model over the ES->ES pass without
training.  `availability_scheduler=True` makes the 2-step rule skip
unreachable neighbours, `link_delay` breaks its ties by ES-pair delay, and
`dynamic` ("leo", "iov") swaps in each round's graph before the hop
(`core/dynamics.py`).  With no sampler the path is the full-participation
round, unmasked.

`client_microbatch` and `precision` are the round engine's memory knobs
(`core/engine.py`); a precision policy forces delta mode, prices the dense
uplink at its wire width (unless a channel or `qsgd_levels` is given) and
every model broadcast too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.comm.channels import Channel, DenseChannel, channel_wire_bits
from repro_torch.core.dynamics import make_dynamic
from repro_torch.core.engine import (
    RoundEngine,
    ScanPlan,
    run_scan,
    scan_cluster_delta_body,
    scan_grad_body,
    uplink_keys,
)
from repro_torch.core.ledger import CommLedger
from repro_torch.core.precision import Precision, downlink_bits_per_param, resolve_channel
from repro_torch.core.prng import PRNGKey, split_chain
from repro_torch.core.scheduler import (
    AvailabilityAwareScheduler,
    FedCHSScheduler,
    LatencyAwareScheduler,
)
from repro_torch.core.simulation import FLTask, RunRecorder, RunResult
from repro_torch.core.topology import make_topology
from repro_torch.data.sources import scatter_put, stage_chunk
from repro_torch.optim.local import PlainSGD
from repro_torch.optim.schedules import Schedule, paper_sqrt_schedule
from repro_torch.part import is_full_participation, participation_mask
from repro_torch.utils import tree_leaves

# reference config fields this port does not implement yet, with their
# defaults: setting one away from its default raises
_NOT_PORTED = {"obs": None, "mesh": None, "checkpoint": None, "checkpoint_every": 1,
               "resume": False}


@dataclasses.dataclass
class FedCHSConfig:
    rounds: int = 200                      # T
    local_steps: int = 20                  # K (total in-cluster iterations)
    local_epochs: int = 1                  # E (local steps per upload); K % E == 0
    topology: str = "random_sparse"        # paper B.1: random sparse, degree <= 3
    topology_seed: int = 0
    dynamic: str | None = None             # "leo" / "iov": per-round graphs
                                           # (core/dynamics.py, Appendix D)
    initial_cluster: int | None = None     # None -> random per Algorithm 1 line 4
    eval_every: int = 10
    bits_per_param: int = 32
    qsgd_levels: int | None = None         # uplink compression (None = dense)
    channel: Channel | None = None         # explicit uplink channel; overrides
                                           # qsgd_levels/bits_per_param
    local_opt: Any = None                  # client-held optimizer; None = PlainSGD
    link_delay: Callable[[int, int], float] | None = None
                                           # ES-pair delay (seconds): switches the
                                           # scheduler to LatencyAwareScheduler
    sampler: Any = None                    # per-round participation
                                           # (repro_torch.part); None /
                                           # FullParticipation = the unmasked path
    availability_scheduler: bool = False   # with a sampler: 2-step rule over
                                           # reachable neighbours only
    track_events: bool = True              # False: bits only, no CommEvent stream
    scan_rounds: bool = True               # whole-run executor (False: looped)
    chunk_rounds: int = 32                 # rounds staged per chunk (scanned)
    seed: int = 0
    schedule: Schedule | None = None       # default: paper eta_k = 1/(K sqrt(k+1))
    client_microbatch: int | None = None   # at most this many client replicas
                                           # train at once (None: all)
    precision: Precision | None = None     # mixed-precision policy
                                           # (core/precision.py): bf16 client
                                           # compute, f32 master, bf16 wire
    # not ported (see _NOT_PORTED): must keep their defaults
    obs: Any = None
    mesh: Any = None
    checkpoint: str | None = None
    checkpoint_every: int = 1
    resume: bool = False

    def __post_init__(self):
        unset = [f for f, default in _NOT_PORTED.items() if getattr(self, f) != default]
        if unset:
            raise NotImplementedError(
                f"FedCHSConfig fields not ported to repro_torch yet: {unset}")


def _make_scheduler(task: FLTask, config: FedCHSConfig, topo, m0: int):
    """The 2-step rule, availability-aware with `availability_scheduler`,
    latency-aware with `link_delay`, the paper's own otherwise."""
    if config.availability_scheduler:
        assert config.sampler is not None, "availability_scheduler needs a sampler"

        def reachable(m_: int, r: int) -> bool:
            return len(config.sampler.participants(r, task.cluster_members[m_])) > 0

        return AvailabilityAwareScheduler(topo, task.cluster_sizes, reachable, initial=m0)
    if config.link_delay is not None:
        return LatencyAwareScheduler(topo, task.cluster_sizes, config.link_delay, initial=m0)
    return FedCHSScheduler(topo, task.cluster_sizes, initial=m0)


def run_fed_chs(task: FLTask, config: FedCHSConfig) -> RunResult:
    if config.scan_rounds:
        return _run_fed_chs_scanned(task, config)
    task.reset_loaders(config.seed)
    assert config.local_steps % config.local_epochs == 0, "K must divide by E"
    K, E = config.local_steps, config.local_epochs
    interactions = K // E
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    lrs = np.array([sched_fn(k) for k in range(K)], dtype=np.float32)
    lrs_grouped = lrs.reshape(interactions, E)
    lrs_grad = torch.from_numpy(lrs).to(task.device)

    dyn = None
    if config.dynamic is not None:
        dyn = make_dynamic(config.dynamic, task.num_clusters, seed=config.topology_seed)
        topo = dyn(0)
    else:
        topo = make_topology(config.topology, task.num_clusters, seed=config.topology_seed)
    rng = np.random.default_rng(config.seed)
    m0 = (
        int(rng.integers(task.num_clusters))
        if config.initial_cluster is None
        else config.initial_cluster
    )
    full_part = is_full_participation(config.sampler)
    scheduler = _make_scheduler(task, config, topo, m0)

    params = task.init_params()  # drawn once: the sizes below come from it
    leaf_sizes = tuple(leaf.numel() for leaf in tree_leaves(params))
    d = sum(leaf_sizes)
    ledger = CommLedger(track_events=config.track_events)
    channel = resolve_channel(config.precision, config.channel, config.qsgd_levels,
                              config.bits_per_param)
    engine = RoundEngine(task.model, channel, local_opt=config.local_opt,
                         client_microbatch=config.client_microbatch,
                         precision=config.precision)
    key = PRNGKey(config.seed + 1)
    lrs_t = engine.step_sizes(lrs_grouped, task.device)

    # a model broadcast travels at the wire width under a policy
    down_bits = DenseChannel(
        downlink_bits_per_param(config.precision, config.bits_per_param)).message_bits(d)
    up_bits = channel_wire_bits(channel, d, leaf_sizes)

    # literal Eq. (5): E=1 dense plain-SGD interactions are gradient uplinks;
    # a lossy dense wire, a stateful optimizer, a sampler (dropouts need the
    # masked round) or a precision policy (grad mode is the f32 arm) takes
    # delta mode
    grad_mode = (
        full_part
        and E == 1
        and isinstance(channel, DenseChannel)
        and channel.wire_dtype is None
        and config.precision is None
        and (config.local_opt is None or isinstance(config.local_opt, PlainSGD))
    )
    opt_states: dict[int, Any] = {}  # cluster -> stacked client-held opt state

    recorder = RunRecorder(task, config.rounds, config.eval_every)
    m = scheduler.state.current
    losses = torch.full((1,), float("nan"))  # stays nan until a first trained round
    for t in range(config.rounds):
        members = task.cluster_members[m]
        participating = members if full_part else config.sampler.participants(t, members)
        if grad_mode:
            gammas = torch.from_numpy(task.cluster_weights(m)).to(task.device)
            batch = task.sample_cluster_batches(m, K)
            params, losses = engine.grad_round(params, batch, gammas, lrs_grad)
        elif participating:
            pmask = None
            w = task.cluster_weights(m)
            if not full_part:
                # masked round: gammas renormalized over the participants on
                # the host, as the reference does; batches are staged at full
                # cluster width, so the data schedule does not depend on churn
                pmask = participation_mask(members, participating)
                w = w * pmask
                w = (w / w.sum()).astype(np.float32)
            gammas = torch.from_numpy(w).to(task.device)
            batch = task.sample_round_batches(m, K, E)
            subs = None
            if channel.stochastic:
                key, subs = split_chain(key, interactions)
            if m not in opt_states:
                opt_states[m] = engine.init_opt_state(params, len(members))
            if pmask is not None:
                pmask = torch.from_numpy(pmask).to(task.device)
            params, opt_states[m], losses = engine.cluster_round(
                params, batch, gammas, lrs_t, subs, opt_states[m], mask=pmask)
        # else: the whole cluster is unavailable, and the ES is a pass-through
        # hop: no training, no draws, no keys, no client traffic; the model is
        # forwarded on the ES->ES pass below (losses keeps its last value)

        # comm accounting: one broadcast + one upload per participating
        # client per interaction, metered per message so netsim sees the
        # phase barriers
        es, prev_m = f"es:{m}", m
        if participating:
            if ledger.track_events:
                for j in range(interactions):
                    for i in participating:
                        ledger.record("es_to_client", down_bits, round=t, phase=j,
                                      sender=es, receiver=f"client:{i}")
                        ledger.record("client_to_es", up_bits, round=t, phase=j,
                                      sender=f"client:{i}", receiver=es)
            else:
                ledger.record("es_to_client", down_bits, interactions * len(participating))
                ledger.record("client_to_es", up_bits, interactions * len(participating))

        # next passing cluster (2-step rule) + one ES->ES model hop; under a
        # dynamic network the ES sees this round's graph when it chooses
        if dyn is not None:
            scheduler.set_topology(dyn(t))
        m = scheduler.advance()
        ledger.record("es_to_es", down_bits, round=t, phase=interactions,
                      sender=f"es:{prev_m}", receiver=f"es:{m}")
        engine.end_round(ledger, t)
        recorder.record(t, params, losses)

    return recorder.result("fed_chs", ledger, params)


# --------------------------------------------------------------------------
# the whole-run executor's plan: the schedule on the host, staged in chunks
# --------------------------------------------------------------------------


def _fed_chs_scan_plan(task: FLTask, source, config: FedCHSConfig):
    """The whole-run `ScanPlan` of one Fed-CHS run, and its deferred glue.

    `source` is the staging data source (the task's own for a single run, a
    per-seed copy for `run_sweep`).  Returns (plan, params_of, traffic):
    `params_of(carry)` the model params, `traffic(track_events)` the
    per-round ledger entries."""
    source.reset(config.seed)
    assert config.local_steps % config.local_epochs == 0, "K must divide by E"
    K, E = config.local_steps, config.local_epochs
    interactions = K // E
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    lrs = np.array([sched_fn(k) for k in range(K)], dtype=np.float32)

    dyn = None
    if config.dynamic is not None:
        dyn = make_dynamic(config.dynamic, task.num_clusters, seed=config.topology_seed)
        topo = dyn(0)
    else:
        topo = make_topology(config.topology, task.num_clusters, seed=config.topology_seed)
    rng = np.random.default_rng(config.seed)
    m0 = (
        int(rng.integers(task.num_clusters))
        if config.initial_cluster is None
        else config.initial_cluster
    )
    full_part = is_full_participation(config.sampler)
    scheduler = _make_scheduler(task, config, topo, m0)
    # visit order incl. m(R): round R-1's ES->ES hop names its receiver;
    # dynamic (IoV/LEO) graphs replay inside
    ms = scheduler.precompute(config.rounds + 1, dynamic=dyn)

    R = config.rounds
    members_of = task.cluster_members
    parts = [
        list(members_of[ms[t]]) if full_part
        else config.sampler.participants(t, members_of[ms[t]])
        for t in range(R)
    ]
    trained = np.array([len(p) > 0 for p in parts])

    params = task.init_params()
    leaf_sizes = tuple(leaf.numel() for leaf in tree_leaves(params))
    d = sum(leaf_sizes)
    channel = resolve_channel(config.precision, config.channel, config.qsgd_levels,
                              config.bits_per_param)
    engine = RoundEngine(task.model, channel, local_opt=config.local_opt,
                         client_microbatch=config.client_microbatch,
                         precision=config.precision)
    grad_mode = (
        full_part
        and E == 1
        and isinstance(channel, DenseChannel)
        and channel.wire_dtype is None
        and config.precision is None
        and (config.local_opt is None or isinstance(config.local_opt, PlainSGD))
    )

    M = task.num_clusters
    n_max = max(len(m) for m in members_of)

    # per-round gamma/mask rows padded to n_max: zero-weight slots add exact
    # zeros, so the padded round equals the looped unpadded one
    gammas_r = np.zeros((R, n_max), np.float32)
    mask_r = np.zeros((R, n_max), np.float32)
    for t in np.flatnonzero(trained):
        members = members_of[ms[t]]
        w = task.cluster_weights(ms[t])
        if full_part:
            gammas_r[t, : len(members)] = w
            mask_r[t, : len(members)] = 1.0
        else:
            pmask = participation_mask(members, parts[t])
            w = w * pmask
            gammas_r[t, : len(members)] = (w / w.sum()).astype(np.float32)
            mask_r[t, : len(members)] = pmask

    # keys: one split chain over the trained rounds draws what the looped
    # driver's per-round `split_chain(key, J)` calls draw
    subs_r = np.zeros((R, interactions, 2), np.uint32)
    keyed = channel.stochastic and channel.per_message
    if channel.stochastic:
        n_tr = int(trained.sum())
        if n_tr:
            _, flat = split_chain(PRNGKey(config.seed + 1), n_tr * interactions)
            subs_r[trained] = flat.reshape(n_tr, interactions, 2)
    width = engine.key_width(n_max)

    def _stage_batches(idxs, reshape, alloc):
        """Every staged batch of the chunk with one bulk read per client; a
        client's draws come in the order of the looped staging (clients
        hold independent streams, so the order across clients does not
        matter)."""
        occ: dict[int, list[int]] = {}
        for c, t in enumerate(idxs):
            occ.setdefault(int(ms[t]), []).append(c)
        plan, pads = [], []
        for m, cs in occ.items():
            members = members_of[m]
            plan += [
                (client, K * len(cs),
                 scatter_put((cs, slice(None), slot), lambda dl, n=len(cs): reshape(n, dl)))
                for slot, client in enumerate(members)
            ]
            if len(members) < n_max:
                pads.append((cs, len(members)))
        batch = stage_chunk(source, plan, lambda a, C=len(idxs): alloc(C, a))
        for cs, n_real in pads:  # padded slots replicate member 0
            for bl in tree_leaves(batch):
                bl[cs, :, n_real:] = bl[cs, :, 0:1]
        return batch

    if grad_mode:
        # leaves (C, K, n_max, B, ...); Fed-CHS restarts the within-round
        # decay every round, so every staged lrs row is the same
        def stage(idxs):
            batch = _stage_batches(
                idxs,
                reshape=lambda n_occ, dl: dl.reshape(n_occ, K, *dl.shape[1:]),
                alloc=lambda C, a: (C, K, n_max) + a.shape[1:],
            )
            return {"batch": batch, "gammas": gammas_r[idxs],
                    "lrs": np.broadcast_to(lrs, (len(idxs), K)).copy()}

        body = scan_grad_body(engine.model, config.client_microbatch)
        carry = params
        consts = {}
        params_of = lambda c: c  # noqa: E731
    else:
        # leaves (C, J, n_max, E, B, ...): the K -> (J, E) grouping of
        # FLTask._stage_round_np
        def stage(idxs):
            batch = _stage_batches(
                idxs,
                reshape=lambda n_occ, dl: dl.reshape(n_occ, interactions, E, *dl.shape[1:]),
                alloc=lambda C, a: (C, interactions, n_max, E) + a.shape[1:],
            )
            xs = {"m": ms[idxs].astype(np.int32), "batch": batch, "gammas": gammas_r[idxs],
                  "mask": mask_r[idxs], "subs": subs_r[idxs]}
            if keyed:
                xs["keys"] = uplink_keys(subs_r[idxs], width, len(leaf_sizes))
            return xs

        body = scan_cluster_delta_body(engine.model, channel, engine.local_opt,
                                       config.client_microbatch, config.precision)
        carry = (params, engine.init_opt_state(params, M, n_max))
        consts = {"lrs": engine.step_sizes(lrs.reshape(interactions, E), task.device)}
        params_of = lambda c: c[0]  # noqa: E731

    plan = ScanPlan(body=body, carry=carry, consts=consts, stage=stage, trained=trained,
                    rounds=R, eval_every=config.eval_every, chunk_rounds=config.chunk_rounds)

    down_bits = DenseChannel(
        downlink_bits_per_param(config.precision, config.bits_per_param)).message_bits(d)
    up_bits = channel_wire_bits(channel, d, leaf_sizes)

    def traffic(track_events: bool):
        """Closed-form per-round ledger entries from the schedule: the
        looped driver's record stream, entry for entry."""
        for t in range(R):
            entries = []
            p = parts[t]
            if p:
                es = f"es:{ms[t]}"
                if track_events:
                    for j in range(interactions):
                        for i in p:
                            entries.append(("es_to_client", down_bits, 1, j, es, f"client:{i}"))
                            entries.append(("client_to_es", up_bits, 1, j, f"client:{i}", es))
                else:
                    entries.append(("es_to_client", down_bits, interactions * len(p), 0,
                                    None, None))
                    entries.append(("client_to_es", up_bits, interactions * len(p), 0,
                                    None, None))
            entries.append(("es_to_es", down_bits, 1, interactions,
                            f"es:{ms[t]}", f"es:{ms[t + 1]}"))
            yield t, entries

    return plan, params_of, traffic


def _run_fed_chs_scanned(task: FLTask, config: FedCHSConfig) -> RunResult:
    plan, params_of, traffic = _fed_chs_scan_plan(task, task.source, config)
    recorder = RunRecorder(task, config.rounds, config.eval_every)
    carry = run_scan(plan, lambda t, c, losses, _lt: recorder.record(t, params_of(c), losses))
    ledger = CommLedger(track_events=config.track_events)
    ledger.materialize(traffic(config.track_events))
    return recorder.result("fed_chs", ledger, params_of(carry))
