"""Per-op attribution over a counted trace (port of
`repro/roofline/attribution.py`): when a roofline term dominates, which
ops are responsible.

  * `collective_breakdown`: collective bytes per (collective, shape,
    named-scope path).
  * `top_output_bytes`: the ops with the most output bytes, views
    excluded; a proxy for which tensors stream through memory.
  * `phase_bytes`: output bytes per phase, a phase being a regex matched
    against each op's named-scope path (`repro_torch.utils.named_scope`,
    which `kernels/ops.py` puts around the QSGD and Sign-SGD wire
    transforms and `core/engine.py` around a round's local training,
    uplink and in-cluster aggregation).

All read a `roofline.analysis.Trace`, whose shapes are per device.
"""
from __future__ import annotations

import re
from collections import defaultdict

from repro_torch.roofline.analysis import Trace


def collective_breakdown(trace: Trace, *, top: int = 20) -> list[dict]:
    """Collective bytes grouped by (op, shape, source scope)."""
    agg: dict = defaultdict(float)
    for op, _, _, _, _, shape, scope, kind, b in trace.events:
        if kind is not None:
            agg[(kind, str(shape)[:64], scope[-80:] or op)] += b
    rows = [{"op": op, "shape": shape, "source": tag, "bytes": b}
            for (op, shape, tag), b in sorted(agg.items(), key=lambda kv: -kv[1])]
    return rows[:top]


def phase_bytes(trace: Trace, phases: dict[str, str]) -> dict[str, float]:
    """Output bytes per phase: each op's named-scope path is matched
    against the regexes of `phases` in turn, the first match takes it;
    unmatched ops are billed to "other".

    Example: the packed-QSGD wire's cost inside a traced round::

        with counting() as tr:
            round_fn(...)
        phase_bytes(tr, {"encode": r"qsgd_encode", "decode": r"qsgd_decode"})
    """
    pats = {name: re.compile(p) for name, p in phases.items()}
    agg: dict = defaultdict(float)
    for _, _, _, _, b_out, _, scope, kind, _ in trace.events:
        if kind is not None:
            continue
        for name, pat in pats.items():
            if pat.search(scope):
                agg[name] += b_out
                break
        else:
            agg["other"] += b_out
    return dict(agg)


def top_output_bytes(trace: Trace, *, top: int = 25) -> list[dict]:
    """The ops with the most output bytes (a memory-traffic proxy): op
    name, its place in the trace, output shape and bytes."""
    rows = [{"op": op, "name": f"{op}.{i}", "shape": str(shape)[:64], "bytes": float(b_out)}
            for i, (op, _, _, _, b_out, shape, _, kind, _) in enumerate(trace.events)
            if kind is None]
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:top]
