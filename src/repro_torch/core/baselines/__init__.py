"""The paper's baselines, looped drivers (port of `repro/core/baselines/`)."""
from repro_torch.core.baselines.fedavg import FedAvgConfig, run_fedavg
from repro_torch.core.baselines.hier_local_qsgd import HierLocalQSGDConfig, run_hier_local_qsgd
from repro_torch.core.baselines.wrwgd import WRWGDConfig, run_wrwgd

__all__ = [
    "FedAvgConfig",
    "run_fedavg",
    "WRWGDConfig",
    "run_wrwgd",
    "HierLocalQSGDConfig",
    "run_hier_local_qsgd",
]
