"""Weighted Random-Walk Gradient Descent (Ayache & El Rouayheb, 2019)
baseline, the looped driver (port of `repro/core/baselines/wrwgd.py`).

The model walks over a client-level graph; each visited client runs K
local SGD steps (one engine grad round with a single client), then forwards
the model to a neighbor drawn with probability proportional to its dataset
size (or uniformly).  One client->client model hop per round, metered at the
dense width.  The walk is host-side numpy rng, replayed draw for draw as the
reference does it.

Participation (`repro_torch.part`): `WRWGDConfig.sampler` gates both ends
of the walk.  A visited client that is down this round forwards the model
without training (and draws no data); the next hop is drawn from the
neighbours that are up next round, or from all of them when none is.

`scan_rounds=True` (the default, as in the reference) runs the whole-run
executor (`_wrwgd_scan_plan`: the walk replayed on the host, each visit's
step sizes staged with its batches, a captured CUDA graph per round on the
card); `scan_rounds=False` the looped driver.  Both give the same params
bit for bit and the same ledger.

`obs` (`repro_torch.obs.RunTelemetry`) traces the run's phases and, with
its taps on, records each trained round's tele, in both executors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.comm.channels import DenseChannel, channel_wire_bits
from repro_torch.core.engine import RoundEngine, ScanPlan, run_scan, scan_grad_body
from repro_torch.core.ledger import CommLedger
from repro_torch.core.simulation import FLTask, RunRecorder, RunResult
from repro_torch.core.topology import make_topology
from repro_torch.data.sources import scatter_put, stage_chunk
from repro_torch.obs.trace import maybe_span
from repro_torch.optim.schedules import Schedule, paper_sqrt_schedule
from repro_torch.part import is_full_participation
from repro_torch.utils import tree_leaves, tree_map

# reference config fields this port does not implement yet: setting one raises
_NOT_PORTED = ("mesh",)


@dataclasses.dataclass
class WRWGDConfig:
    rounds: int = 200
    local_steps: int = 20
    topology: str = "random_sparse"   # client-level graph, degree <= 3 (paper B.1)
    topology_seed: int = 0
    weighting: str = "data_size"      # or "uniform"
    sampler: Any = None               # per-round participation (repro_torch.part);
                                      # None / FullParticipation = every visit trains
    track_events: bool = True         # False: bits only, no CommEvent stream
    scan_rounds: bool = True          # whole-run executor (False: looped)
    chunk_rounds: int = 32            # rounds staged per chunk (scanned)
    eval_every: int = 10
    bits_per_param: int = 32
    seed: int = 0
    schedule: Schedule | None = None  # walk round t -> eta_t, constant over the
                                      # K local steps of that visit
    client_microbatch: int | None = None  # passed to the round engine; a walk
                                          # visits one client per round, so any
                                          # value trains that one client
    obs: Any = None                       # repro_torch.obs.RunTelemetry
    mesh: Any = None                      # not ported (see _NOT_PORTED)

    def __post_init__(self):
        unset = [f for f in _NOT_PORTED if getattr(self, f) is not None]
        if unset:
            raise NotImplementedError(
                f"WRWGDConfig fields not ported to repro_torch yet: {unset}")


def _precompute_walk(task: FLTask, config: WRWGDConfig):
    """Replay the walk's host rng draw for draw: (visits (R,), trains (R,)
    bool, hops [(sender, receiver)]).  Under full participation every
    visited client trains."""
    topo = make_topology(config.topology, task.num_clients, seed=config.topology_seed)
    rng = np.random.default_rng(config.seed)
    current = int(rng.integers(task.num_clients))
    full_part = is_full_participation(config.sampler)
    visits, trains, hops = [], [], []
    for t in range(config.rounds):
        visits.append(current)
        trains.append(full_part or bool(config.sampler.participants(t, [current])))
        nbrs = list(topo.neighbors(current))
        if not full_part:
            nbrs = config.sampler.participants(t + 1, nbrs) or nbrs
        if config.weighting == "data_size":
            w = task.client_sizes[nbrs]
            w = w / w.sum()
        else:
            w = np.full(len(nbrs), 1.0 / len(nbrs))
        nxt = int(rng.choice(nbrs, p=w))
        hops.append((current, nxt))
        current = nxt
    return np.asarray(visits), np.asarray(trains), hops


def _walk_round_lrs(config: WRWGDConfig) -> np.ndarray:
    """(R, K) step sizes: row t is eta_t repeated over the K local steps.
    The decay is indexed by the global walk round t, as in the reference:
    the walk revisits clients forever, so restarting it per visit would
    never anneal."""
    K = config.local_steps
    sched_fn = config.schedule or paper_sqrt_schedule(K, half=False)
    etas = np.asarray([sched_fn(t) for t in range(config.rounds)], np.float32)
    return np.repeat(etas[:, None], K, axis=1)


def run_wrwgd(task: FLTask, config: WRWGDConfig) -> RunResult:
    if config.scan_rounds:
        return _run_wrwgd_scanned(task, config)
    task.reset_loaders(config.seed)
    lrs_r = _walk_round_lrs(config)

    params = task.init_params()
    leaf_sizes = tuple(leaf.numel() for leaf in tree_leaves(params))
    ledger = CommLedger(track_events=config.track_events)
    channel = DenseChannel(config.bits_per_param)
    engine = RoundEngine(task.model, channel, client_microbatch=config.client_microbatch)
    hop_bits = channel_wire_bits(channel, sum(leaf_sizes), leaf_sizes)
    gamma_one = torch.ones((1,), dtype=torch.float32, device=task.device)

    visits, trains_r, hops = _precompute_walk(task, config)
    obs = config.obs
    taps = obs is not None and obs.taps
    recorder = RunRecorder(task, config.rounds, config.eval_every, obs=obs)
    losses = torch.full((1,), float("nan"))  # stays nan until a first trained round
    for t in range(config.rounds):
        if trains_r[t]:
            # (K, 1, B, ...): a walk step is a 1-client cluster running Eq. (5)
            batch = tree_map(lambda a: a[:, None],
                             task.sample_client_batches(int(visits[t]), config.local_steps))
            with maybe_span(obs, "round"):
                out = engine.grad_round(params, batch, gamma_one, lrs_r[t], taps=taps)
                params, losses = out[:2]
            if taps:
                obs.record_round(t, out[2])
        # else: the visited client is down, a pass-through: the model is
        # forwarded untouched and the round draws no data
        prev, nxt = hops[t]
        ledger.record("client_to_client", hop_bits, round=t, phase=0,
                      sender=f"client:{prev}", receiver=f"client:{nxt}")
        engine.end_round(ledger, t)
        recorder.record(t, params, losses)

    return recorder.result("wrwgd", ledger, params)


# --------------------------------------------------------------------------
# the whole-run executor's plan
# --------------------------------------------------------------------------


def _wrwgd_scan_plan(task: FLTask, source, config: WRWGDConfig):
    """Whole-run `ScanPlan` + deferred glue (see `fed_chs._fed_chs_scan_plan`)."""
    source.reset(config.seed)
    K = config.local_steps
    lrs_r = _walk_round_lrs(config)

    params = task.init_params()
    leaf_sizes = tuple(leaf.numel() for leaf in tree_leaves(params))
    channel = DenseChannel(config.bits_per_param)
    engine = RoundEngine(task.model, channel, client_microbatch=config.client_microbatch)
    visits, trains, hops = _precompute_walk(task, config)
    ones = np.ones((config.rounds, 1), np.float32)

    def stage(idxs):
        C = len(idxs)
        occ: dict[int, list[int]] = {}
        for c, t in enumerate(idxs):
            occ.setdefault(int(visits[t]), []).append(c)
        batch = stage_chunk(
            source,
            [(client, K * len(cs),
              scatter_put((cs, slice(None), 0),
                          lambda dl, n=len(cs): dl.reshape(n, K, *dl.shape[1:])))
             for client, cs in occ.items()],
            lambda a: (C, K, 1) + a.shape[1:],
        )
        return {"batch": batch, "gammas": ones[idxs], "lrs": lrs_r[idxs]}

    plan = ScanPlan(
        body=scan_grad_body(engine.model, config.client_microbatch,
                            config.obs is not None and config.obs.taps),
        carry=params, consts={}, stage=stage, trained=trains, rounds=config.rounds,
        eval_every=config.eval_every, chunk_rounds=config.chunk_rounds, obs=config.obs,
    )
    hop_bits = channel_wire_bits(channel, sum(leaf_sizes), leaf_sizes)

    def traffic(track_events: bool):
        del track_events  # one metered hop per round either way
        for t, (prev, nxt) in enumerate(hops):
            yield t, [("client_to_client", hop_bits, 1, 0, f"client:{prev}", f"client:{nxt}")]

    return plan, (lambda c: c), traffic


def _run_wrwgd_scanned(task: FLTask, config: WRWGDConfig) -> RunResult:
    obs = config.obs
    with maybe_span(obs, "precompute"):
        plan, params_of, traffic = _wrwgd_scan_plan(task, task.source, config)
    recorder = RunRecorder(task, config.rounds, config.eval_every, obs=obs)
    carry = run_scan(plan, lambda t, c, losses, _lt: recorder.record(t, params_of(c), losses))
    ledger = CommLedger(track_events=config.track_events)
    with maybe_span(obs, "materialize"):
        ledger.materialize(traffic(config.track_events))
    return recorder.result("wrwgd", ledger, params_of(carry))
