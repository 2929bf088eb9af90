"""Roofline analysis (port of `repro/roofline/`): per-device FLOPs, bytes
and collective bytes of a step from a counted trace, priced on `H100`."""
from repro_torch.roofline.analysis import (
    H100,
    HW,
    analyze_trace,
    counting,
    model_flops,
    roofline_terms,
)

__all__ = ["HW", "H100", "analyze_trace", "counting", "roofline_terms", "model_flops"]
