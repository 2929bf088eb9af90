"""Per-hop link models and per-node compute models for the network simulator.

The paper's §3.2 overhead model counts information *bits* per hop type and is
deliberately silent about *time* — that is what lets Fed-CHS claim a win by
hop-count arithmetic alone.  This module supplies the missing physical layer
so `repro_torch.netsim.events` can turn the bit ledger into wall-clock:

  * `LinkModel` — one hop class (wireless client<->ES, backhaul ES<->ES, WAN
    anything<->PS): a sustained `bandwidth_bps`, a fixed per-message
    `latency_s` (propagation + protocol), and bounded multiplicative jitter.
  * `ComputeModel` — effective local-SGD throughput (flops/s); per-node
    heterogeneity and stragglers are seeded multiplicative speed factors.
  * `NetworkModel` — the bundle: resolves (hop, sender, receiver, bits,
    round) -> seconds and (node, flops, round) -> seconds, deterministically
    given (seed, inputs).  All randomness (jitter draw, straggler
    assignment, per-pair backhaul spread) is derived from crc32-hashed
    stable keys, so two identical runs produce identical timelines and the
    model is replayable without storing any state.

Dynamic topologies (repro_torch/core/dynamics.py) plug in via `dynamics`: an
ES->ES transfer over a link that is invisible this round (LEO node out of
window) or faded-but-repaired (IoV Gilbert drop) runs at
`degraded_frac * bandwidth` — a flaky link costs time, it does not lose the
bits §3.2 already counted.

Everything is classical simulation on the host (numpy only) — no torch here;
the training computation this clocks was already done by the round engine.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import numpy as np

__all__ = [
    "HOP_LINK_CLASS",
    "LinkModel",
    "ComputeModel",
    "NetworkModel",
    "sgd_step_flops",
    "edge_cloud_network",
]

# hop type (repro_torch.core.ledger.HOPS) -> link class
HOP_LINK_CLASS = {
    "client_to_es": "wireless",
    "es_to_client": "wireless",
    "client_to_client": "wireless",
    "es_to_es": "backhaul",
    "es_to_ps": "wan",
    "ps_to_es": "wan",
    "client_to_ps": "wan",
    "ps_to_client": "wan",
}


def _rng(*key) -> np.random.Generator:
    """Deterministic, platform-stable generator from a structured key."""
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def sgd_step_flops(num_params: int, batch_size: int) -> float:
    """Estimated flops of ONE local SGD step on a dense model.

    Forward + backward of a dense network is ~3x the forward's 2*d
    multiply-adds per sample (the standard 6*N*D rule), so one step over a
    batch of B samples costs ~6 * d * B flops.  Good to a small constant
    factor for the paper's MLP/LeNet — and the constant cancels in
    algorithm *comparisons*, which all share one model.
    """
    return 6.0 * float(num_params) * float(batch_size)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One class of physical link."""

    bandwidth_bps: float          # sustained throughput
    latency_s: float = 0.0        # fixed per-message cost (propagation + protocol)
    jitter: float = 0.0           # max fractional uniform jitter on transfer time

    def base_time(self, n_bits: float) -> float:
        return self.latency_s + n_bits / self.bandwidth_bps


@dataclasses.dataclass(frozen=True)
class ComputeModel:
    """Effective local-training throughput of a baseline node."""

    flops_per_second: float = 5e9  # modest edge CPU/NPU


@dataclasses.dataclass
class NetworkModel:
    """Deterministic physical network: hops -> seconds, flops -> seconds.

    `heterogeneity` spreads per-node compute speed uniformly in
    [1 - h, 1 + h]; a seeded `straggler_frac` fraction of nodes is
    additionally `straggler_slowdown`x slower in BOTH compute and their
    wireless access link (the HiFlash-style device straggler).
    `backhaul_spread` gives each unordered ES pair a fixed multiplicative
    delay factor in [1, 1 + spread] — the per-edge diversity the
    `LatencyAwareScheduler` tie-break exploits.

    By default every directed link is dedicated: n parallel uploads into a
    server each run at full link speed, so a star round costs the *max* over
    clients (the contract pinned in tests/test_netsim.py, deliberately
    client-favorable — it makes Fed-CHS time wins conservative).
    `shared_ingress=True` instead splits a receiver's bandwidth across the
    `fan_in` concurrent senders of an aggregation phase (processor-sharing
    approximation), modeling the PS ingress bottleneck the paper's §1
    argues star topologies pay at scale.
    """

    wireless: LinkModel = LinkModel(bandwidth_bps=50e6, latency_s=2e-3, jitter=0.0)
    backhaul: LinkModel = LinkModel(bandwidth_bps=1e9, latency_s=5e-3, jitter=0.0)
    wan: LinkModel = LinkModel(bandwidth_bps=100e6, latency_s=25e-3, jitter=0.0)
    compute: ComputeModel = ComputeModel()
    seed: int = 0
    heterogeneity: float = 0.0
    straggler_frac: float = 0.0
    straggler_slowdown: float = 4.0
    backhaul_spread: float = 0.0
    shared_ingress: bool = False       # split receiver bandwidth across fan-in
    dynamics: Callable | None = None   # DynamicTopology (round -> Topology)
    degraded_frac: float = 0.1         # bandwidth multiplier on flaky ES links
    deadline_s: float | None = None    # per-interaction reporting deadline: a
                                       # client whose broadcast->compute->upload
                                       # chain exceeds it is dropped by the
                                       # aggregator (bits saved, wall-clock
                                       # wasted — see netsim/adapters.py)
    _node_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- per-node models ---------------------------------------------------

    def is_straggler(self, node: str) -> bool:
        return self._node(node)[1]

    def node_speed(self, node: str) -> float:
        """Compute-speed multiplier of `node` (1.0 = baseline)."""
        return self._node(node)[0]

    def _node(self, node: str) -> tuple[float, bool]:
        cached = self._node_cache.get(node)
        if cached is None:
            g = _rng(self.seed, "node", node)
            speed = 1.0 + self.heterogeneity * (2.0 * g.random() - 1.0)
            straggler = g.random() < self.straggler_frac
            if straggler:
                speed /= self.straggler_slowdown
            cached = self._node_cache[node] = (speed, straggler)
        return cached

    def compute_time(self, node: str, flops: float, round_idx: int = 0) -> float:
        """Seconds for `node` to execute `flops` of local training."""
        del round_idx  # speeds are static per node; hook kept for extensions
        return flops / (self.compute.flops_per_second * self.node_speed(node))

    # -- per-link models ---------------------------------------------------

    def _link(self, hop: str) -> LinkModel:
        return getattr(self, HOP_LINK_CLASS[hop])

    def _pair_factor(self, a: str, b: str) -> float:
        """Fixed per-unordered-pair backhaul delay multiplier in [1, 1+spread]."""
        if self.backhaul_spread == 0.0:
            return 1.0
        lo, hi = sorted((a, b))
        return 1.0 + self.backhaul_spread * _rng(self.seed, "pair", lo, hi).random()

    def _es_degraded(self, sender: str, receiver: str, round_idx: int) -> bool:
        """Is this ES->ES link flaky this round (invisible or Gilbert-dropped)?"""
        if self.dynamics is None:
            return False
        a, b = int(sender.split(":")[1]), int(receiver.split(":")[1])
        topo = self.dynamics(round_idx)
        if b not in topo.neighbors(a):
            return True
        dropped = getattr(self.dynamics, "dropped", None)
        if dropped is not None and (min(a, b), max(a, b)) in dropped(round_idx):
            return True
        return False

    def transfer_time(
        self,
        hop: str,
        sender: str,
        receiver: str,
        n_bits: float,
        round_idx: int = 0,
        phase: int = 0,
        fan_in: int = 1,
    ) -> float:
        """Seconds to move one `n_bits` message over `hop` in (round, phase).

        `phase` only salts the jitter draw — without it, every message
        between the same pair within a round would share one draw, which
        correlates jitter across a multi-interaction round and biases
        multi-phase algorithms (Fed-CHS) against single-phase ones (FedAvg).
        `fan_in` is how many senders upload to this receiver concurrently in
        this phase; it divides bandwidth only under `shared_ingress`.
        """
        link = self._link(hop)
        bw = link.bandwidth_bps
        if self.shared_ingress and fan_in > 1:
            bw /= fan_in
        # a straggler's radio is as slow as its CPU
        for end in (sender, receiver):
            if end.startswith("client:") and self.is_straggler(end):
                bw /= self.straggler_slowdown
        factor = 1.0
        if hop == "es_to_es":
            factor = self._pair_factor(sender, receiver)
            if self._es_degraded(sender, receiver, round_idx):
                bw *= self.degraded_frac
        t = (link.latency_s + n_bits / bw) * factor
        if link.jitter:
            u = _rng(self.seed, "jitter", hop, sender, receiver, round_idx, phase).random()
            t *= 1.0 + link.jitter * u
        return t

    def nominal_chain_s(self, link_class: str, n_bits: float, flops: float) -> float:
        """A nominal (no-straggler, no-jitter, baseline-speed) client chain:
        broadcast -> `flops` of local compute -> upload, both transfers of
        `n_bits` over `link_class` ("wireless" / "wan" / "backhaul").  The
        reference point for setting reporting deadlines — heterogeneity stays
        within a small multiple of it, stragglers blow through it (see the
        deadline semantics in netsim/adapters.py)."""
        link: LinkModel = getattr(self, link_class)
        return 2 * link.base_time(n_bits) + flops / self.compute.flops_per_second

    def backhaul_delay(self, a: int, b: int, n_bits: float) -> float:
        """Expected ES->ES model-pass delay — the `LatencyAwareScheduler`
        tie-break cost (no jitter, no round-specific degradation: the
        scheduler ranks links by their *nominal* quality)."""
        return self.backhaul.base_time(n_bits) * self._pair_factor(f"es:{a}", f"es:{b}")

    def link_delay_fn(self, n_bits: float) -> Callable[[int, int], float]:
        """`backhaul_delay` bound to a message size — plug directly into
        `FedCHSConfig.link_delay`."""
        return lambda a, b: self.backhaul_delay(a, b, n_bits)


def edge_cloud_network(
    *,
    seed: int = 0,
    wireless_mbps: float = 50.0,
    backhaul_mbps: float = 1000.0,
    wan_mbps: float = 100.0,
    wan_latency_ms: float = 25.0,
    flops_per_second: float = 5e9,
    heterogeneity: float = 0.0,
    straggler_frac: float = 0.0,
    straggler_slowdown: float = 4.0,
    backhaul_spread: float = 0.0,
    jitter: float = 0.0,
    dynamics: Callable | None = None,
    deadline_s: float | None = None,
) -> NetworkModel:
    """The canonical deployment the paper sketches: clients on access
    wireless, ESs on a metro backhaul, the (baselines-only) PS across a WAN."""
    return NetworkModel(
        wireless=LinkModel(wireless_mbps * 1e6, latency_s=2e-3, jitter=jitter),
        backhaul=LinkModel(backhaul_mbps * 1e6, latency_s=5e-3, jitter=jitter),
        wan=LinkModel(wan_mbps * 1e6, latency_s=wan_latency_ms * 1e-3, jitter=jitter),
        compute=ComputeModel(flops_per_second),
        seed=seed,
        heterogeneity=heterogeneity,
        straggler_frac=straggler_frac,
        straggler_slowdown=straggler_slowdown,
        backhaul_spread=backhaul_spread,
        dynamics=dynamics,
        deadline_s=deadline_s,
    )
