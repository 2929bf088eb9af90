"""Event-driven Fed-CHS: the ES->ES chain fires on quorum/deadline (port of
`repro/async_fl/fed_chs.py`).

The synchronous driver advances one barrier round per ES visit; here the
netsim timeline is the control flow.  Activation a of the chain:

  1. The model lands at ES m(a) at simulated time t_a (the visit order is
     the paper's 2-step rule, time-free, so it is precomputed as the
     scanned synchronous driver does).
  2. The ES broadcasts to the cluster members the availability trace says
     are up; each dispatched client's broadcast -> K local steps -> upload
     chain gets a deterministic arrival time from the `NetworkModel`
     (stragglers, heterogeneity, shared ingress all apply).  The cohort's
     local steps and uplinks run as one computation
     (`compute.client_updates_fn`).
  3. The ES fires at `fire_time`: the quorum_frac-th arrival, capped by
     `deadline_s`.  On-time updates fold at staleness tau = 0; late ones
     wait in the ES's bounded `StalenessBuffer` and fold, discounted by
     ``gamma * (1 + tau)^(-alpha)`` (tau in model versions), when the chain
     next visits this ES, or are evicted once they exceed `max_staleness`.
  4. One ES->ES hop to m(a+1); its transfer time advances the clock.

With AlwaysOn clients, quorum 1.0 and no deadline, every fold is the full
cohort at tau = 0, and the run is the synchronous
`run_fed_chs(local_epochs=K)` bit for bit.

A late update's delta is cloned when it enters the buffer, so a buffered
update holds its own storage and never keeps its whole stacked cohort
alive; on-time updates fold from views of the cohort and are dropped.

Checkpointing: `checkpoint=` saves the complete run state at every
`checkpoint_every`-th activation boundary (params, per-cluster optimizer
stacks, buffered deltas, the key chain's words, per-client draw counts,
the simulated clock, ledger state and eval logs) through
`checkpoint.save_run_state`, and calls `on_checkpoint(next activation)`
after each save.  `resume=True` restores all of it, so a run killed
between two activations continues bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.async_fl.arrivals import dispatch_cohort, fire_time
from repro_torch.async_fl.buffer import StalenessBuffer, Update, staleness_weight
from repro_torch.async_fl.compute import client_updates_fn, fold_fn, no_subs, stack_updates
from repro_torch.checkpoint.io import (
    load_run_state,
    read_run_meta,
    run_state_exists,
    save_run_state,
)
from repro_torch.comm.channels import Channel, DenseChannel, channel_wire_bits, make_channel
from repro_torch.core.ledger import CommLedger
from repro_torch.core.prng import PRNGKey, split_chain
from repro_torch.core.scheduler import FedCHSScheduler
from repro_torch.core.simulation import FLTask, RunRecorder, RunResult
from repro_torch.core.topology import make_topology
from repro_torch.data.sources import bulk_batches
from repro_torch.netsim.links import NetworkModel, edge_cloud_network
from repro_torch.optim.local import PlainSGD
from repro_torch.optim.schedules import Schedule, paper_sqrt_schedule
from repro_torch.part import AlwaysOn, AvailabilityTrace
from repro_torch.utils import tree_leaves, tree_map

Tree = Any
PyTree = Tree  # the reference's name


@dataclasses.dataclass
class AsyncFedCHSConfig:
    rounds: int = 60                       # activations (ES visits)
    local_steps: int = 10                  # K local steps per dispatched update
    topology: str = "random_sparse"
    topology_seed: int = 0
    initial_cluster: int | None = None
    network: NetworkModel | None = None    # physical layer; default
                                           # edge_cloud_network()
    trace: AvailabilityTrace | None = None # per-(client, version) churn;
                                           # default AlwaysOn
    quorum_frac: float = 1.0               # fire at the ceil(frac*cohort)-th
                                           # arrival ...
    deadline_s: float | None = None        # ... capped by this wait (seconds)
    staleness_alpha: float = 0.5           # discount exponent (1+tau)^(-alpha)
    max_staleness: int | None = 8          # drop updates older than this many
                                           # model versions (None: unbounded)
    renormalize: bool = False              # True: fold weights sum to 1;
                                           # False keeps raw discounted gammas
                                           # (the sync-anchor-exact choice)
    eval_every: int = 10
    bits_per_param: int = 32
    qsgd_levels: int | None = None
    channel: Channel | None = None
    local_opt: Any = None                  # client-held optimizer; None = PlainSGD
    track_events: bool = True
    seed: int = 0
    schedule: Schedule | None = None       # local step k -> eta_k (the Eq. (5)
                                           # within-visit decay, as sync)
    checkpoint: str | None = None          # path prefix of the continuous state
    checkpoint_every: int = 1              # activations between saves
    resume: bool = False                   # load the checkpoint if present
    on_checkpoint: Any = None              # called with the next activation
                                           # index after every save


@dataclasses.dataclass
class _AsyncState:
    """Everything the event loop carries across activations."""

    activation: int
    sim_time: float
    params: Tree
    opt_states: dict            # cluster -> stacked (n_m, ...) optimizer tree
    buffers: dict               # cluster -> StalenessBuffer
    key: np.ndarray             # uint32 key words of the chain
    losses: Any                 # last cohort's (j,) losses, or None
    ledger: CommLedger
    recorder: RunRecorder
    sim_eval_times: list
    draw_counts: list = dataclasses.field(default_factory=list)


def _resolve(config):
    network = config.network or edge_cloud_network()
    trace = config.trace or AlwaysOn()
    channel = (config.channel if config.channel is not None
               else make_channel(config.qsgd_levels, config.bits_per_param))
    opt = config.local_opt or PlainSGD()
    return network, trace, channel, opt


def init_opt_rows(opt, params: Tree, n: int) -> Tree:
    """Fresh optimizer state for n clients, leaves (n, ...) of their own."""
    return tree_map(lambda leaf: leaf.expand((n,) + leaf.shape).clone(), opt.init(params))


def stage_clients(task: FLTask, clients: list[int], steps: int) -> dict:
    """The next `steps` batches of each client, stacked (n, steps, B, ...) on
    the task's device in one copy per leaf; the draws are the ones
    `FLTask.sample_client_batches` takes client by client."""
    per = [bulk_batches(task.source, i, steps) for i in clients]
    return {k: torch.from_numpy(np.stack([b[k] for b in per])).to(task.device) for k in per[0]}


def take_rows(tree: Tree, idx: torch.Tensor) -> Tree:
    return tree_map(lambda leaf: leaf.index_select(0, idx), tree)


def put_rows(tree: Tree, idx: torch.Tensor, rows: Tree) -> None:
    for leaf, r in zip(tree_leaves(tree), tree_leaves(rows)):
        leaf.index_copy_(0, idx, r)


def own_storage(u: Update) -> Update:
    """`u` with a delta of its own (a clone of the cohort's view)."""
    return dataclasses.replace(u, delta=tree_map(torch.clone, u.delta))


def _visit_order(task: FLTask, config: AsyncFedCHSConfig) -> np.ndarray:
    topo = make_topology(config.topology, task.num_clusters, seed=config.topology_seed)
    rng = np.random.default_rng(config.seed)
    m0 = (int(rng.integers(task.num_clusters)) if config.initial_cluster is None
          else config.initial_cluster)
    return FedCHSScheduler(topo, task.cluster_sizes, initial=m0).precompute(config.rounds + 1)


# --------------------------------------------------------------------------
# checkpoint plumbing
# --------------------------------------------------------------------------


def _state_arrays(state: _AsyncState) -> tuple[Tree, dict]:
    pending_arrays: dict[str, Tree] = {}
    pending_meta = []
    i = 0
    for m in sorted(state.buffers):
        for u in state.buffers[m].updates:
            k = f"u{i}"
            pending_arrays[k] = u.delta
            pending_meta.append({"key": k, "client": u.client, "cluster": u.cluster,
                                 "version": u.version, "arrival": u.arrival,
                                 "gamma": u.gamma})
            i += 1
    arrays = {"params": state.params, "key": state.key,
              "opt": {str(m): s for m, s in state.opt_states.items()},
              "pending": pending_arrays}
    meta = {
        "algo": "async_fed_chs",
        "activation": state.activation,
        "sim_time": state.sim_time,
        "pending": pending_meta,
        "dropped": {str(m): b.dropped for m, b in state.buffers.items()},
        "opt_clusters": sorted(state.opt_states),
        "ledger": state.ledger.state_dict(),
        "recorder": {"rounds": state.recorder.rounds_log, "acc": state.recorder.acc_log,
                     "loss": state.recorder.loss_log, "sim": state.sim_eval_times},
        "losses_shape": None if state.losses is None else list(state.losses.shape),
    }
    if state.losses is not None:
        arrays["losses"] = state.losses
    return arrays, meta


def save_async_state(path: str, state: _AsyncState) -> None:
    arrays, meta = _state_arrays(state)
    meta["draw_counts"] = list(state.draw_counts)
    save_run_state(path, arrays, meta)


def load_async_state(path: str, task: FLTask, config: AsyncFedCHSConfig,
                     engine_like) -> _AsyncState:
    """Rebuild the event loop's state from a `save_run_state` checkpoint.

    The meta sidecar is read first: it names the pending updates and the
    visited clusters, which gives the `like` structure the arrays are
    verified against.  `engine_like` is (params0, init_opt(params, n))."""
    params0, init_opt = engine_like
    meta = read_run_meta(path)
    like = {
        "params": params0,
        "key": PRNGKey(0),
        "opt": {str(m): init_opt(params0, len(task.cluster_members[int(m)]))
                for m in meta["opt_clusters"]},
        "pending": {p["key"]: params0 for p in meta["pending"]},
    }
    if meta["losses_shape"] is not None:
        like["losses"] = torch.zeros(meta["losses_shape"], device=task.device)
    arrays, meta = load_run_state(path, like)

    buffers: dict[int, StalenessBuffer] = {}
    for p in meta["pending"]:
        m = int(p["cluster"])
        buffers.setdefault(m, StalenessBuffer(max_staleness=config.max_staleness)).add(Update(
            client=int(p["client"]), cluster=m, version=int(p["version"]),
            arrival=float(p["arrival"]), gamma=float(p["gamma"]),
            delta=arrays["pending"][p["key"]]))
    for m_s, n in meta["dropped"].items():
        buffers.setdefault(
            int(m_s), StalenessBuffer(max_staleness=config.max_staleness)).dropped = int(n)

    ledger = CommLedger(track_events=config.track_events)
    ledger.load_state(meta["ledger"])
    recorder = RunRecorder(task, config.rounds, config.eval_every)
    recorder.rounds_log = list(meta["recorder"]["rounds"])
    recorder.acc_log = list(meta["recorder"]["acc"])
    recorder.loss_log = list(meta["recorder"]["loss"])

    task.source.fast_forward(meta["draw_counts"])
    return _AsyncState(
        activation=int(meta["activation"]),
        sim_time=float(meta["sim_time"]),
        params=arrays["params"],
        opt_states={int(m): s for m, s in arrays["opt"].items()},
        buffers=buffers,
        key=arrays["key"],
        losses=arrays.get("losses"),
        ledger=ledger,
        recorder=recorder,
        sim_eval_times=list(meta["recorder"]["sim"]),
    )


# --------------------------------------------------------------------------
# the event loop
# --------------------------------------------------------------------------


def run_async_fed_chs(task: FLTask, config: AsyncFedCHSConfig) -> RunResult:
    network, trace, channel, opt = _resolve(config)
    K = config.local_steps
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    lrs = torch.as_tensor(np.asarray([sched_fn(k) for k in range(K)], np.float32),
                          device=task.device)

    ms = _visit_order(task, config)
    d = task.num_params()
    down_bits = DenseChannel(config.bits_per_param).message_bits(d)
    up_bits = channel_wire_bits(channel, d, task.param_leaf_sizes())
    updates = client_updates_fn(task.fed_model, channel, opt)
    fold = fold_fn(task.fed_model)

    def init_opt(params, n):
        return init_opt_rows(opt, params, n)

    task.reset_loaders(config.seed)
    if config.resume and config.checkpoint and run_state_exists(config.checkpoint):
        state = load_async_state(config.checkpoint, task, config,
                                 (task.init_params(), init_opt))
    else:
        state = _AsyncState(
            activation=0, sim_time=0.0, params=task.init_params(), opt_states={},
            buffers={}, key=PRNGKey(config.seed + 1), losses=None,
            ledger=CommLedger(track_events=config.track_events),
            recorder=RunRecorder(task, config.rounds, config.eval_every),
            sim_eval_times=[])

    ledger, recorder = state.ledger, state.recorder
    for a in range(state.activation, config.rounds):
        m = int(ms[a])
        members = task.cluster_members[m]
        es = f"es:{m}"
        gammas = task.cluster_weights(m)  # float32, member order
        buf = state.buffers.setdefault(m, StalenessBuffer(max_staleness=config.max_staleness))

        # stale evictions: the bits were spent; meter them at their terminal
        # staleness so the histogram records what bounded staleness discarded
        for u in buf.evict_stale(a):
            ledger.record("client_to_es", up_bits, round=a, phase=1,
                          sender=f"client:{u.client}", receiver=f"es:{u.cluster}",
                          staleness=a - u.version)

        # dispatch this activation's cohort (availability probed at version a)
        dispatches = dispatch_cohort(
            network, trace, server=es, cluster=m, members=list(members), version=a,
            start=state.sim_time, down_bits=down_bits, up_bits=up_bits, num_params=d,
            batch_size=task.batch_size, local_steps=K)
        cohort = [dsp.client for dsp in dispatches]
        cohort_updates: list[Update] = []
        if cohort:
            slots = [members.index(i) for i in cohort]
            # K draws per dispatched client; clients that are asleep draw nothing
            batch = stage_clients(task, cohort, K)
            if m not in state.opt_states:
                state.opt_states[m] = init_opt(state.params, len(members))
            idx = torch.as_tensor(slots, dtype=torch.long, device=task.device)
            sub = no_subs()
            if channel.stochastic:
                state.key, subs = split_chain(state.key, 1)
                sub = subs[0]
            deltas, new_opt, losses = updates(
                state.params, take_rows(state.opt_states[m], idx), batch, lrs, sub)
            put_rows(state.opt_states[m], idx, new_opt)
            state.losses = losses
            for j, dsp in enumerate(dispatches):
                cohort_updates.append(Update(
                    client=dsp.client, cluster=m, version=a, arrival=dsp.arrival,
                    gamma=float(gammas[slots[j]]),
                    delta=tree_map(lambda leaf, j=j: leaf[j], deltas)))
            for dsp in dispatches:
                ledger.record("es_to_client", down_bits, round=a, phase=0,
                              sender=es, receiver=f"client:{dsp.client}")

        t_fire = fire_time(dispatches, quorum_frac=config.quorum_frac,
                           deadline_s=config.deadline_s, start=state.sim_time)

        folded = buf.take_arrived(t_fire)
        for u in cohort_updates:
            if u.arrival <= t_fire:
                folded.append(u)
            else:
                buf.updates.append(own_storage(u))
        folded.sort(key=lambda u: (u.version, u.arrival, u.client))

        if folded:
            w = np.asarray([staleness_weight(u.gamma, a - u.version, config.staleness_alpha)
                            for u in folded], np.float32)
            if config.renormalize:
                w = w / w.sum()
            state.params = fold(state.params, stack_updates([u.delta for u in folded]),
                                torch.as_tensor(w, device=task.device))
            for u in folded:
                ledger.record("client_to_es", up_bits, round=a, phase=1,
                              sender=f"client:{u.client}", receiver=es,
                              staleness=a - u.version)
        del cohort_updates, folded

        # ES -> ES hop: the chain moves on at the fire time
        nxt = int(ms[a + 1])
        hop_s = network.transfer_time("es_to_es", es, f"es:{nxt}", down_bits,
                                      round_idx=a, phase=2)
        ledger.record("es_to_es", down_bits, round=a, phase=2, sender=es,
                      receiver=f"es:{nxt}")
        ledger.snapshot(a)
        state.sim_time = t_fire + hop_s

        if recorder.should_eval(a):
            state.sim_eval_times.append(t_fire)
        recorder.record(a, state.params, state.losses)

        state.activation = a + 1
        if config.checkpoint and (a + 1) % config.checkpoint_every == 0:
            state.draw_counts = list(task.source.draw_counts)
            save_async_state(config.checkpoint, state)
            if config.on_checkpoint is not None:
                config.on_checkpoint(a + 1)

    res = recorder.result("async_fed_chs", ledger, state.params)
    return dataclasses.replace(res, sim_times=list(state.sim_eval_times))
