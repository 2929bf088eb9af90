"""Client-held local optimizers and learning-rate schedules (the names
`repro.optim` exports)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_step
from repro_torch.optim.local import AdamWOpt, LocalOpt, MomentumSGD, PlainSGD
from repro_torch.optim.schedules import (
    constant_schedule,
    nonconvex_schedule,
    paper_power_schedule,
    paper_sqrt_schedule,
)
from repro_torch.optim.sgd import SGDConfig, sgd_init, sgd_step

__all__ = [
    "paper_sqrt_schedule",
    "paper_power_schedule",
    "constant_schedule",
    "nonconvex_schedule",
    "sgd_init",
    "sgd_step",
    "SGDConfig",
    "adamw_init",
    "adamw_step",
    "AdamWConfig",
    "LocalOpt",
    "PlainSGD",
    "MomentumSGD",
    "AdamWOpt",
]
