"""Carry parameters from the reference package into the port.

The port stores weights in the reference's layout (dense (in, out), conv
HWIO, a transformer's layers stacked on a leading axis), so the conversion
is a copy of every leaf, key for key and index for index.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils import resolve_device


def params_from_jax(np_tree: Any, device=None) -> Any:
    """Tree of arrays (e.g. `np.asarray` of the reference's params or
    caches: dicts and lists) -> the same tree of tensors on `device` (the
    card unless asked), each leaf in its own dtype: a bf16 leaf (numpy's
    `ml_dtypes.bfloat16`, which torch cannot read) goes across as its bit
    pattern, so an f32 router inside a bf16 tree stays f32."""
    device = resolve_device(device)
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return type(np_tree)(params_from_jax(v, device) for v in np_tree)
    arr = np.array(np_tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
