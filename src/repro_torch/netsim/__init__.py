# repro_torch.netsim — event-driven network/time simulation over the bit ledger.
# Turns a recorded run's CommEvent stream into wall-clock time-to-accuracy:
# link + compute models (links.py), a deterministic DAG/resource event
# simulator (events.py), and per-algorithm adapters (adapters.py).
from repro_torch.netsim.adapters import (
    build_jobs,
    replay_run,
    simulate_run,
    time_to_accuracy,
    timeline_for,
)
from repro_torch.netsim.events import Job, Timeline, simulate
from repro_torch.netsim.links import (
    ComputeModel,
    LinkModel,
    NetworkModel,
    edge_cloud_network,
    sgd_step_flops,
)

__all__ = [
    "Job",
    "Timeline",
    "simulate",
    "ComputeModel",
    "LinkModel",
    "NetworkModel",
    "edge_cloud_network",
    "sgd_step_flops",
    "build_jobs",
    "replay_run",
    "timeline_for",
    "simulate_run",
    "time_to_accuracy",
]
