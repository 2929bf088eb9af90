"""The ambient mesh (port of `repro/sharding/ctx.py`).

A driver whose config names no mesh adopts the one published here if it is
a federation mesh (`sharding.fed.resolve_mesh`): a caller can shard every
run inside a block without threading a `mesh` argument through each
config::

    with model_mesh(make_federation_mesh(2, 2)):
        run_fed_chs(task, config)   # config.mesh=None adopts it
"""
from __future__ import annotations

import contextlib
from typing import Any

_STACK: list[Any] = []


@contextlib.contextmanager
def model_mesh(mesh: Any):
    """Publish `mesh` for the duration of the block (None publishes nothing)."""
    if mesh is None:
        yield
        return
    _STACK.append(mesh)
    try:
        yield
    finally:
        _STACK.pop()


def current_mesh() -> Any:
    return _STACK[-1] if _STACK else None
