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

`obs` (`repro_torch.obs.RunTelemetry`) traces both executors' phases
("precompute", "stage", "scan_chunk", "materialize" scanned; "round"
looped; "eval" in both) and, with its taps on, records each round's tele;
the tapped rounds' params equal the untapped rounds' bit for bit.
`checkpoint` saves the looped driver's whole round-boundary state every
`checkpoint_every` rounds (`repro_torch.checkpoint.save_run_state`:
params, optimizer stacks, the key chain, scheduler, data draws, ledger and
logs), and `resume=True` continues from it bit for bit; a run with a
checkpoint takes the looped driver, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.io import (
    load_run_state,
    read_run_meta,
    run_state_exists,
    save_run_state,
)
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
from repro_torch.obs.trace import maybe_span
from repro_torch.optim.local import PlainSGD
from repro_torch.optim.schedules import Schedule, paper_sqrt_schedule
from repro_torch.part import is_full_participation, participation_mask
from repro_torch.sharding.fed import resolve_mesh, shard_plan
from repro_torch.utils import tree_leaves


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
    obs: Any = None                        # repro_torch.obs.RunTelemetry
    mesh: Any = None                       # launch.mesh.FederationMesh: split the
                                           # scanned round's client axis over its
                                           # ranks (repro_torch.sharding.fed, bit
                                           # for bit); None adopts an ambient
                                           # federation mesh (sharding.ctx).  The
                                           # looped driver ignores it
    checkpoint: str | None = None          # path prefix of the looped run state
    checkpoint_every: int = 1              # rounds between saves
    resume: bool = False                   # continue from `checkpoint` if saved


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


def _save_sync_state(path: str, task: FLTask, t_next: int, params, opt_states, key,
                     losses, scheduler, ledger, recorder) -> None:
    """Save the looped driver's whole round-boundary state (atomic), in the
    reference's layout: a file either package writes loads in the other."""
    arrays = {"params": params, "key": key, "losses": losses,
              "opt": {str(m): s for m, s in opt_states.items()}}
    meta = {
        "algo": "fed_chs",
        "round": t_next,
        "scheduler": {
            "current": int(scheduler.state.current),
            "visit_counts": [int(c) for c in scheduler.state.visit_counts],
            "step": int(scheduler.state.step),
        },
        "opt_clusters": sorted(opt_states),
        "losses_shape": list(losses.shape),
        "losses_dtype": str(losses.dtype).removeprefix("torch."),
        "draw_counts": list(task.source.draw_counts),
        "ledger": ledger.state_dict(),
        "recorder": {"rounds": recorder.rounds_log, "acc": recorder.acc_log,
                     "loss": recorder.loss_log},
    }
    save_run_state(path, arrays, meta)


def _load_sync_state(path: str, task: FLTask, params0, engine, scheduler, ledger, recorder):
    """Restore the looped driver's state; returns (t, params, opt_states,
    key, losses).  Sets the scheduler, ledger, recorder and data source in
    place.  The losses come back in the dtype they were saved in (a file of
    the reference, which does not record it, holds f32)."""
    meta = read_run_meta(path)
    like = {
        "params": params0,
        "key": PRNGKey(0),
        "losses": torch.zeros(meta["losses_shape"], device=task.device,
                              dtype=getattr(torch, meta.get("losses_dtype", "float32"))),
        "opt": {str(m): engine.init_opt_state(params0, len(task.cluster_members[int(m)]))
                for m in meta["opt_clusters"]},
    }
    arrays, meta = load_run_state(path, like)
    st = meta["scheduler"]
    scheduler.state.current = int(st["current"])
    scheduler.state.visit_counts = np.asarray(st["visit_counts"], np.int64)
    scheduler.state.step = int(st["step"])
    ledger.load_state(meta["ledger"])
    recorder.rounds_log = list(meta["recorder"]["rounds"])
    recorder.acc_log = list(meta["recorder"]["acc"])
    recorder.loss_log = list(meta["recorder"]["loss"])
    task.source.fast_forward(meta["draw_counts"])
    opt_states = {int(m): s for m, s in arrays["opt"].items()}
    return int(meta["round"]), arrays["params"], opt_states, arrays["key"], arrays["losses"]


def run_fed_chs(task: FLTask, config: FedCHSConfig) -> RunResult:
    if config.scan_rounds and not config.checkpoint:
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

    obs = config.obs
    taps = obs is not None and obs.taps
    recorder = RunRecorder(task, config.rounds, config.eval_every, obs=obs)
    m = scheduler.state.current
    losses = torch.full((1,), float("nan"))  # stays nan until a first trained round
    start_round = 0
    if config.resume and config.checkpoint and run_state_exists(config.checkpoint):
        start_round, params, opt_states, key, losses = _load_sync_state(
            config.checkpoint, task, params, engine, scheduler, ledger, recorder)
        m = scheduler.state.current
    for t in range(start_round, config.rounds):
        members = task.cluster_members[m]
        participating = members if full_part else config.sampler.participants(t, members)
        out = None
        if grad_mode:
            gammas = torch.from_numpy(task.cluster_weights(m)).to(task.device)
            batch = task.sample_cluster_batches(m, K)
            with maybe_span(obs, "round"):
                out = engine.grad_round(params, batch, gammas, lrs_grad, taps=taps)
                params, losses = out[:2]
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
            with maybe_span(obs, "round"):
                out = engine.cluster_round(params, batch, gammas, lrs_t, subs, opt_states[m],
                                           mask=pmask, taps=taps)
                params, opt_states[m], losses = out[:3]
        # else: the whole cluster is unavailable, and the ES is a pass-through
        # hop: no training, no draws, no keys, no client traffic; the model is
        # forwarded on the ES->ES pass below (losses keeps its last value)
        if taps and out is not None:
            obs.record_round(t, out[-1])

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
        if config.checkpoint and (t + 1) % config.checkpoint_every == 0:
            _save_sync_state(config.checkpoint, task, t + 1, params, opt_states, key, losses,
                             scheduler, ledger, recorder)

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
    taps = config.obs is not None and config.obs.taps

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

        body = scan_grad_body(engine.model, config.client_microbatch, taps)
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
                                       config.client_microbatch, config.precision, taps)
        carry = (params, engine.init_opt_state(params, M, n_max))
        consts = {"lrs": engine.step_sizes(lrs.reshape(interactions, E), task.device)}
        params_of = lambda c: c[0]  # noqa: E731

    plan = ScanPlan(body=body, carry=carry, consts=consts, stage=stage, trained=trained,
                    rounds=R, eval_every=config.eval_every, chunk_rounds=config.chunk_rounds,
                    obs=config.obs)

    mesh = resolve_mesh(config.mesh)
    if mesh is not None:
        # two memory strategies that exclude each other: the mesh splits the
        # client axis over ranks, client_microbatch folds it in time
        assert config.client_microbatch is None, \
            "client_microbatch and a federation mesh are mutually exclusive"
        # one cluster trains a round: its client axis spreads over the whole mesh
        if grad_mode:
            plan = shard_plan(plan, mesh, "grad", model=engine.model, clients=n_max)
        else:
            plan = shard_plan(plan, mesh, "cluster_delta", model=engine.model,
                              channel=channel, opt=engine.local_opt, clients=n_max,
                              lrs=lrs.reshape(interactions, E))

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
    obs = config.obs
    with maybe_span(obs, "precompute"):
        plan, params_of, traffic = _fed_chs_scan_plan(task, task.source, config)
    recorder = RunRecorder(task, config.rounds, config.eval_every, obs=obs)
    carry = run_scan(plan, lambda t, c, losses, _lt: recorder.record(t, params_of(c), losses))
    ledger = CommLedger(track_events=config.track_events)
    with maybe_span(obs, "materialize"):
        ledger.materialize(traffic(config.track_events))
    return recorder.result("fed_chs", ledger, params_of(carry))
