"""Multi-seed sweeps: N whole runs as one run of N lanes (port of
`repro/core/sweep.py`).

The averaging regime FL papers report over (mean +/- std across seeds)
costs N sequential runs in a looped simulator.  With the whole-run
executor the only per-seed state is the carry and the staged inputs (visit
orders, keys, data draws), so a sweep runs one round body that advances
every seed's lane in turn (`engine.run_scan_sweep`): on the card one
captured CUDA graph, one replay per round for all seeds.

Plans are built exactly like the single-run scanned drivers', with
per-seed shallow copies of the task's data source, so every seed draws its
own batch stream from shared dataset arrays and the task's own source
keeps its position.  Each lane computes exactly its solo scanned run (the
same operations at the same shapes), so a lane equals `run_*(task,
dataclasses.replace(config, seed=s))` bit for bit, in every mode.  (The
reference vmaps a chunk over the seed axis, which holds delta-mode lanes
only to about an ulp per round of their solo runs.)

Scope: full-participation configs, the table-1 regime.  A sampler changes
which rounds train per seed, which would give the seeds different
schedules; run those seeds one by one instead.
"""
from __future__ import annotations

import copy
import dataclasses

from repro_torch.core.baselines.fedavg import FedAvgConfig, _fedavg_scan_plan
from repro_torch.core.baselines.hier_local_qsgd import HierLocalQSGDConfig, _hier_scan_plan
from repro_torch.core.baselines.wrwgd import WRWGDConfig, _wrwgd_scan_plan
from repro_torch.core.engine import run_scan_sweep
from repro_torch.core.fed_chs import FedCHSConfig, _fed_chs_scan_plan
from repro_torch.core.ledger import CommLedger
from repro_torch.core.simulation import FLTask, RunRecorder, RunResult
from repro_torch.part import is_full_participation

_PLANNERS = {
    FedCHSConfig: ("fed_chs", _fed_chs_scan_plan),
    FedAvgConfig: ("fedavg", _fedavg_scan_plan),
    WRWGDConfig: ("wrwgd", _wrwgd_scan_plan),
    HierLocalQSGDConfig: ("hier_local_qsgd", _hier_scan_plan),
}


def run_sweep(task: FLTask, config, seeds, *, mesh=None) -> list[RunResult]:
    """Run `config` at every seed in `seeds` as one multi-lane scanned run.

    `config` is any of the four driver configs; returns one `RunResult` per
    seed, in order, each equal to `run_*(task, dataclasses.replace(config,
    seed=s))`.  `mesh` (a `launch.mesh.FederationMesh`) splits the seed
    lanes over its ranks (`engine.run_scan_sweep`); it excludes
    ``config.mesh``, which splits the client axes of one run."""
    name, planner = _PLANNERS[type(config)]
    assert getattr(config, "mesh", None) is None, \
        "run_sweep shards the seed axis — a config.mesh (client-axis sharding) cannot be " \
        "combined with a sweep; pass run_sweep(mesh=...) instead"
    assert config.scan_rounds, \
        "run_sweep is scanned by nature: a scan_rounds=False config asks for the " \
        "looped driver; run those seeds one by one through the driver instead"
    assert is_full_participation(config.sampler), \
        "run_sweep shares one trained-round schedule across seeds: sampler-driven " \
        "runs must go through the per-seed drivers"
    assert config.obs is None, "telemetry is per-run host state; profile a single run"

    seeds = list(seeds)
    plans, params_ofs, traffics = [], [], []
    for s in seeds:
        cfg = dataclasses.replace(config, seed=s)
        # per-seed batch streams over shared dataset arrays: shallow-copy the
        # source, then reset(seed) rebinds only its per-client stream state
        out = planner(task, copy.copy(task.source), cfg)
        plans.append(out[0])
        params_ofs.append(out[1])
        traffics.append(out[2])

    params_of = params_ofs[0]
    recorders = [RunRecorder(task, config.rounds, config.eval_every) for _ in seeds]

    def record(t, carry, losses, _last_t):
        for i, lane in enumerate(carry):
            recorders[i].record(t, params_of(lane), None if losses is None else losses[i])

    carry = run_scan_sweep(plans, record, mesh=mesh)
    results = []
    for i, lane in enumerate(carry):
        ledger = CommLedger(track_events=config.track_events)
        ledger.materialize(traffics[i](config.track_events))
        results.append(recorders[i].result(name, ledger, params_of(lane)))
    return results
