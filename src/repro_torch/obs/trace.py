"""Host-side span tracer: nested wall-clock spans over driver phases (copy
of `repro/obs/trace.py`, with a torch profiler passthrough).

The tracer records ("B", name, ts) / ("E", name, ts) tuples in emission
order — Chrome-trace duration events.  Because spans are context managers
opened and closed on one host thread, emission order alone guarantees the
B/E pairs are well nested; `obs.export` re-emits them verbatim onto the
"host" track of the merged timeline.

Timestamps come from ``time.perf_counter()`` (monotonic, sub-µs), rebased
so the first event of a trace sits at t=0.  When ``profiler=True`` each
span additionally enters a ``torch.profiler.record_function`` so the same
phase names show up inside a captured `torch.profiler` trace — a
passthrough only: no profiler session is started here and the range costs
next to nothing without one.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class SpanTracer:
    """Collects nested host spans; cheap enough to leave on everywhere."""

    profiler: bool = False  # also enter torch.profiler.record_function
    events: list[tuple[str, str, float]] = field(default_factory=list)
    _t0: float | None = None

    def _now(self) -> float:
        t = time.perf_counter()
        if self._t0 is None:
            self._t0 = t
        return t - self._t0

    @contextlib.contextmanager
    def span(self, name: str):
        ann = None
        if self.profiler:
            import torch.profiler

            ann = torch.profiler.record_function(name)
            ann.__enter__()
        self.events.append(("B", name, self._now()))
        try:
            yield self
        finally:
            self.events.append(("E", name, self._now()))
            if ann is not None:
                ann.__exit__(None, None, None)

    def wall(self, name: str) -> float:
        """Total seconds spent inside spans called `name` (closed pairs)."""
        total, stack = 0.0, []
        for kind, n, ts in self.events:
            if n != name:
                continue
            if kind == "B":
                stack.append(ts)
            elif stack:
                total += ts - stack.pop()
        return total


def maybe_span(obs, name: str):
    """`obs.span(name)` when observability is on, else a no-op context.

    Drivers call this unconditionally; the `obs=None` fast path costs one
    `None` check per phase and touches no tracer state.
    """
    if obs is None:
        return contextlib.nullcontext()
    return obs.span(name)
