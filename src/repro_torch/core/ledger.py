"""Bit-exact communication accounting + the structured message-event stream.

The paper's §3.2 "Communication Overhead" paragraph and Fig. 2 count information
bits for three hop types:
  * client -> ES uplink (gradients)
  * ES -> client broadcast (model)
  * ES -> ES sequential pass (model)          [Fed-CHS only]
  * ES -> PS / PS -> ES / client <-> PS hops  [baselines]

Each model/gradient vector of d floats costs Q bits (Q = 32 d uncompressed; QSGD
compression changes Q per message and the ledger records the compressed size).

§3.2 counts *bits*; it deliberately says nothing about *time*.  To let the
repo also answer "is Fed-CHS's serial ES->ES pass actually faster than the
baselines' parallel uploads on a real network?" (the HiFlash-style
time-to-accuracy question), `record` optionally attaches per-message metadata
— (round, phase, sender, receiver) — producing a structured `CommEvent`
stream that `repro.netsim` replays through link models into wall-clock
timestamps.  The metadata is accounting-neutral: aggregate `bits`/`messages`
are bit-identical whether or not metadata is supplied.

Node naming convention (shared with `repro.netsim`): ``"client:<i>"``,
``"es:<m>"``, ``"ps"``.  `phase` orders traffic within a round — for
in-cluster traffic it is the interaction index (each interaction is
broadcast -> local compute -> upload), and inter-tier hops (ES->ES, ES->PS,
PS->ES) use phases after the last interaction.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import NamedTuple

from repro_torch.comm.bits import dense_message_bits, qsgd_message_bits, topk_message_bits

__all__ = [
    "HOPS",
    "CommEvent",
    "CommLedger",
    "dense_message_bits",
    "qsgd_message_bits",
    "topk_message_bits",
]

HOPS = (
    "client_to_es",
    "es_to_client",
    "es_to_es",
    "es_to_ps",
    "ps_to_es",
    "client_to_ps",
    "ps_to_client",
    "client_to_client",
)


class CommEvent(NamedTuple):
    """One metered message: who sent what to whom, when in the protocol."""

    round: int
    phase: int
    hop: str
    sender: str
    receiver: str
    n_bits: int


@dataclasses.dataclass
class CommLedger:
    bits: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    messages: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    history: list = dataclasses.field(default_factory=list)  # (round, total_bits) snapshots
    events: list = dataclasses.field(default_factory=list)   # CommEvent stream
    track_events: bool = True  # False drops metadata (saves memory at --full scale)
    staleness: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int)
    )  # histogram: staleness tau (in fold versions) -> message count; fed by
    #    the async drivers' fold-in path (tau=0 for on-time updates)

    def record(
        self,
        hop: str,
        n_bits: int,
        count: int = 1,
        *,
        round: int | None = None,
        phase: int = 0,
        sender: str | None = None,
        receiver: str | None = None,
        staleness: int | None = None,
    ) -> None:
        """Meter `count` messages of `n_bits` over `hop`.

        With (round, sender, receiver) metadata, also appends `count`
        structured `CommEvent`s for the network simulator; aggregates are
        identical either way.  `staleness` (async drivers: how many model
        versions behind the fold this update was computed at) feeds the
        per-message staleness histogram.
        """
        assert hop in HOPS, f"unknown hop {hop}"
        assert n_bits >= 0 and count >= 0
        self.bits[hop] += n_bits * count
        self.messages[hop] += count
        if staleness is not None:
            self.staleness[int(staleness)] += count
        if self.track_events and round is not None:
            ev = CommEvent(round, phase, hop, sender or "?", receiver or "?", n_bits)
            self.events.extend([ev] * count)

    def staleness_histogram(self) -> dict[int, int]:
        """{tau: messages folded at staleness tau}, sorted by tau."""
        return dict(sorted(self.staleness.items()))

    def state_dict(self) -> dict:
        """JSON-serialisable snapshot of the full ledger, for run checkpoints
        (`checkpoint.save_run_state`).  `load_state` restores bit-identically:
        aggregates, history, staleness histogram, and (when tracked) the
        structured event stream."""
        return {
            "bits": dict(self.bits),
            "messages": dict(self.messages),
            "history": [list(h) for h in self.history],
            "events": [list(e) for e in self.events],
            "track_events": self.track_events,
            "staleness": {str(k): v for k, v in self.staleness.items()},
        }

    def load_state(self, state: dict) -> None:
        self.bits = defaultdict(int, state["bits"])
        self.messages = defaultdict(int, state["messages"])
        self.history = [tuple(h) for h in state["history"]]
        self.events = [CommEvent(*e) for e in state["events"]]
        self.track_events = bool(state["track_events"])
        self.staleness = defaultdict(
            int, {int(k): v for k, v in state.get("staleness", {}).items()}
        )

    def snapshot(self, round_idx: int) -> None:
        self.history.append((round_idx, self.total_bits()))

    def materialize(self, traffic) -> None:
        """Deferred accounting: replay a precomputed per-round traffic plan.

        The scanned whole-run drivers (`engine.run_scan`) perform zero ledger
        appends in the hot loop; every message of a run is a closed-form
        function of the precomputed visit/participation schedule, so the
        driver reconstructs the stream *after* the run by materializing it
        here.  `traffic` yields ``(round_idx, entries)`` in round order, each
        entry a ``(hop, n_bits, count, phase, sender, receiver)`` tuple —
        per-message entries (count=1, named endpoints) when the event stream
        is tracked, aggregate entries otherwise.  Each round is snapshotted
        after its entries, exactly like the looped drivers' `end_round`, so
        aggregates, event stream, and history are bit-identical to a looped
        run of the same schedule (pinned by tests/test_engine_parity.py).
        """
        for round_idx, entries in traffic:
            for hop, n_bits, count, phase, sender, receiver in entries:
                self.record(hop, n_bits, count, round=round_idx, phase=phase,
                            sender=sender, receiver=receiver)
            self.snapshot(round_idx)

    def total_bits(self) -> int:
        return sum(self.bits.values())

    def total_megabytes(self) -> float:
        return self.total_bits() / 8 / 1e6

    def breakdown(self) -> dict[str, int]:
        return {h: self.bits[h] for h in HOPS if self.bits[h]}

    def round_events(self) -> dict[int, list[CommEvent]]:
        """Events grouped by round, each group sorted by (phase, hop, sender)."""
        grouped: dict[int, list[CommEvent]] = defaultdict(list)
        for ev in self.events:
            grouped[ev.round].append(ev)
        for evs in grouped.values():
            evs.sort(key=lambda e: (e.phase, e.hop, e.sender, e.receiver))
        return dict(grouped)

    def event_index(self) -> dict[tuple, list[int]]:
        """Event positions grouped by ``(round, hop, "sender->receiver")`` in
        stream order — the key the netsim adapters use for transfer-job IDs,
        so the merged-timeline exporter (repro.obs.export) can FIFO-match
        each CommEvent to the simulated job that carried it.  Requires
        `track_events`."""
        idx: dict[tuple, list[int]] = defaultdict(list)
        for i, ev in enumerate(self.events):
            idx[(ev.round, ev.hop, f"{ev.sender}->{ev.receiver}")].append(i)
        return dict(idx)

    def round_bits(self, hop: str | None = None) -> dict[int, int]:
        """Per-round bit totals from the event stream (optionally one hop) —
        the closed-form participation checks read this: under a sampler,
        a round's uplink bits are exactly |participants| * bits_per_message.
        Requires `track_events`."""
        out: dict[int, int] = defaultdict(int)
        for ev in self.events:
            if hop is None or ev.hop == hop:
                out[ev.round] += ev.n_bits
        return dict(out)

    def round_senders(self, round_idx: int, hop: str) -> set[str]:
        """Distinct senders over `hop` in one round (requires `track_events`).
        Under a participation sampler this is exactly the sampled set."""
        return {e.sender for e in self.events
                if e.round == round_idx and e.hop == hop}

    def bits_until(self, predicate_round: int) -> int:
        """Total bits recorded at the first snapshot with round >= predicate_round."""
        for r, b in self.history:
            if r >= predicate_round:
                return b
        return self.total_bits()
