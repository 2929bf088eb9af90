"""Architecture configs (a copy of the reference package's `configs/`)."""
from repro_torch.configs.base import ArchConfig, MLAConfig

__all__ = ["ArchConfig", "MLAConfig"]
