"""Checkpoints: parameter trees and resumable run state (port of
`repro/checkpoint/`)."""
from repro_torch.checkpoint.io import (
    load_fl_state,
    load_pytree,
    load_run_state,
    run_state_exists,
    save_fl_state,
    save_pytree,
    save_run_state,
)

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_fl_state",
    "load_fl_state",
    "save_run_state",
    "load_run_state",
    "run_state_exists",
]
