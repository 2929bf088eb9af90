"""Run observability: telemetry taps inside the rounds, host span tracing,
and the merged Chrome-trace/Perfetto exporter (port of `repro/obs/`).

Usage — pass a `RunTelemetry` to any driver config::

    from repro_torch.obs import RunTelemetry
    obs = RunTelemetry()                      # taps + spans
    res = run_fed_chs(task, replace(cfg, obs=obs))
    res.telemetry is obs                      # attached to the RunResult

`obs=None` (the default everywhere) runs the untapped rounds, scan bodies
and captured graphs exactly as without this package.

Telemetry crosses to the host only where the drivers already cross: a
looped round hands its tele dict to `record_round`, and the whole-run
executor hands each chunk's stacked tele to `record_stacked`.  The
crossing is lazy by default: `record_stacked` keeps the device tensors
and copies them to the host on first read, so the executor never waits on
the card between eval points (on the card a chunk of graph replays runs
under `torch.cuda.set_sync_debug_mode("error")`).  `sync_chunks=True`
copies them inside the chunk's `scan_chunk` span instead, so that span
covers the chunk's real execution.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.obs.export import (
    build_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
    write_metrics_jsonl,
)
from repro_torch.obs.trace import SpanTracer, maybe_span

__all__ = [
    "RunTelemetry",
    "SpanTracer",
    "maybe_span",
    "build_chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_metrics_jsonl",
]


def _host(v) -> np.ndarray:
    """A tele value as a host array (a device tensor is copied, and so
    waited for, here)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclass
class RunTelemetry:
    """Carrier for one run's observability state.

    taps        — compute the training-health taps (update_norm, drift,
                  comp_err, mass) per round; False keeps spans only.
    profiler    — also enter `torch.profiler.record_function` per span.
    sync_chunks — copy each chunk's tele to the host inside `record_stacked`,
                  so the enclosing scan_chunk span covers the chunk's device
                  execution; False (default) defers the copy to first read.
    """

    taps: bool = True
    profiler: bool = False
    sync_chunks: bool = False
    tracer: SpanTracer = None  # type: ignore[assignment]
    _rounds: list[int] = field(default_factory=list, repr=False)
    _metrics: dict[str, list[Any]] = field(default_factory=dict, repr=False)
    _pending: list = field(default_factory=list, repr=False)

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = SpanTracer(profiler=self.profiler)

    def span(self, name: str):
        return self.tracer.span(name)

    # -- tele ingestion ----------------------------------------------------
    @property
    def rounds(self) -> list[int]:
        """Round indices with recorded taps (flushes pending chunks)."""
        self._flush()
        return self._rounds

    @property
    def metrics(self) -> dict[str, list[Any]]:
        """Per-tap value lists aligned with `rounds` (flushes pending)."""
        self._flush()
        return self._metrics

    def _append(self, t: int, tele: dict) -> None:
        self._rounds.append(int(t))
        for k, v in tele.items():
            a = _host(v)
            self._metrics.setdefault(k, []).append(
                float(a) if a.ndim == 0 else a.astype(np.float64))

    def _flush(self) -> None:
        while self._pending:
            rounds, tele = self._pending.pop(0)
            host = {k: _host(v) for k, v in tele.items()}
            for i, t in enumerate(rounds):
                self._append(int(t), {k: v[i] for k, v in host.items()})

    def record_round(self, t: int, tele: dict) -> None:
        """One round's tele dict (looped drivers; device scalars are fine)."""
        self._flush()
        self._append(t, tele)

    def record_stacked(self, rounds, tele: dict) -> None:
        """A chunk of stacked tele (the whole-run executor): leaves have a
        leading round axis aligned with `rounds`.  Default: keep the device
        tensors and copy them on first read, so the executor never blocks
        here; with `sync_chunks` the copy happens now."""
        self._pending.append((list(rounds), dict(tele)))
        if self.sync_chunks:
            self._flush()

    # -- views -------------------------------------------------------------
    def metrics_rows(self) -> list[dict]:
        """One flat dict per recorded round (JSONL-ready)."""
        rows = []
        for i, t in enumerate(self.rounds):
            row: dict[str, Any] = {"round": t}
            for k, vs in self.metrics.items():
                v = vs[i]
                row[k] = v.tolist() if isinstance(v, np.ndarray) else v
            rows.append(row)
        return rows

    def summary(self) -> dict:
        """Per-metric mean/max over the run (vector taps flattened)."""
        out: dict[str, dict[str, float]] = {}
        for k, vs in self.metrics.items():
            flat = np.concatenate([np.atleast_1d(np.asarray(v, np.float64))
                                   for v in vs]) if vs else np.zeros(0)
            if flat.size:
                out[k] = {"mean": float(flat.mean()), "max": float(flat.max())}
        return {"rounds": len(self.rounds), "metrics": out,
                "spans": {name: self.tracer.wall(name)
                          for _, name, _ in self.tracer.events
                          if name}}
