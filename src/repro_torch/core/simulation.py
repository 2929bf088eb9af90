"""FL-simulation machinery: the task, round staging, the eval/log tail
(port of `repro/core/simulation.py`).

`FLTask` holds the device of the run: staged batches and parameters live
there.  Its batches come from a data source: the classifier's
``FLTask(model, dataset, clients, ...)`` builds an `ArraySource`, any other
workload passes ``source=`` or uses `FLTask.from_source`.  Staging draws
each client's batches from the same numpy streams as the reference, so a
run of the port sees the reference's batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.ledger import CommLedger
from repro_torch.data.partition import ClientData
from repro_torch.data.sources import ArraySource
from repro_torch.data.synthetic import Dataset
from repro_torch.models.fed import as_fed_model
from repro_torch.obs.trace import maybe_span
from repro_torch.utils import resolve_device, tree_leaves, tree_num_params

Tree = Any
PyTree = Tree  # the reference's name
Batch = Any


def _stack_batches(batches: list[Batch]) -> Batch:
    """Stack equal-structure batch dicts along a new leading axis."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@dataclasses.dataclass
class FLTask:
    """Everything an FL algorithm needs to run one experiment, on `device`
    (the card unless the caller passes ``device="cpu"``)."""

    model: Any
    dataset: Dataset | None
    clients: list[ClientData] | None
    cluster_members: list[list[int]]  # cluster m -> client ids
    batch_size: int
    seed: int = 0
    source: Any = None  # a data source (ArraySource, TokenSource); built if None
    device: Any = None

    def __post_init__(self):
        self.fed_model = as_fed_model(self.model)
        self.device = resolve_device(self.device)
        if self.source is None:
            if self.dataset is None or self.clients is None:
                raise ValueError("FLTask needs either (dataset, clients) or a source")
            self.source = ArraySource(self.dataset, self.clients, self.batch_size,
                                      seed=self.seed)
        self.client_sizes = np.asarray(self.source.client_sizes, dtype=np.float64)
        self.cluster_sizes = [
            int(sum(self.client_sizes[i] for i in members)) for members in self.cluster_members
        ]

    @classmethod
    def from_source(cls, model, source, cluster_members: list[list[int]], *, seed: int = 0,
                    device=None) -> FLTask:
        """Build a task directly over a data source (no array dataset)."""
        return cls(model, None, None, cluster_members, source.batch_size, seed=seed,
                   source=source, device=device)

    def reset_loaders(self, seed: int) -> None:
        self.source.reset(seed)

    @property
    def num_clients(self) -> int:
        return self.source.num_clients

    @property
    def num_clusters(self) -> int:
        return len(self.cluster_members)

    @property
    def metric_name(self) -> str:
        return self.fed_model.metric_name

    @property
    def metric_mode(self) -> str:
        return self.fed_model.metric_mode

    def cluster_weights(self, m: int) -> np.ndarray:
        """gamma_n^m = D_n / D_{A,m} for clients in cluster m."""
        sizes = self.client_sizes[self.cluster_members[m]]
        return (sizes / sizes.sum()).astype(np.float32)

    def global_weights(self) -> np.ndarray:
        """gamma_n = D_n / D_A over all clients (FedAvg weighting)."""
        return (self.client_sizes / self.client_sizes.sum()).astype(np.float32)

    def _to_device(self, batch: Batch) -> Batch:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def sample_cluster_batches(self, m: int, steps: int) -> Batch:
        """Batches for every client of cluster m: leaves (steps, n, B, ...)."""
        members = self.cluster_members[m]
        return self._to_device(_stack_batches([
            _stack_batches([self.source.next_batch(i) for i in members])
            for _ in range(steps)
        ]))

    def sample_client_batches(self, client: int, steps: int) -> Batch:
        """One client's next `steps` batches on the device: leaves (steps, B, ...)."""
        return self._to_device(
            _stack_batches([self.source.next_batch(client) for _ in range(steps)]))

    def _stage_round_np(self, m: int, total_steps: int, epochs: int) -> Batch:
        """One round of cluster-m batches as numpy: leaves (J, n, E, B, ...),
        in the per-client draw order of epochs-sized incremental sampling."""
        assert total_steps % epochs == 0
        members = self.cluster_members[m]
        flat = _stack_batches([
            _stack_batches([self.source.next_batch(i) for i in members])
            for _ in range(total_steps)
        ])  # leaves (K, n, B, ...)
        J = total_steps // epochs
        return {k: a.reshape(J, epochs, *a.shape[1:]).swapaxes(1, 2) for k, a in flat.items()}

    def sample_round_batches(self, m: int, total_steps: int, epochs: int) -> Batch:
        """One whole round of cluster-m batches on the device:
        leaves (J, n, E, B, ...) with J = total_steps // epochs."""
        return self._to_device({k: np.ascontiguousarray(a) for k, a in
                                self._stage_round_np(m, total_steps, epochs).items()})

    def sample_all_cluster_batches(self, total_steps: int, epochs: int) -> Batch:
        """One 3-tier HFL round for every cluster, padded to a uniform client
        width: leaves (J, M, n_max, E, B, ...).  Padded slots replicate the
        cluster's first member and draw nothing extra (their updates are
        masked out downstream, see `padded_cluster_weights`)."""
        n_max = max(len(members) for members in self.cluster_members)
        per_cluster = []
        for m in range(self.num_clusters):
            b = self._stage_round_np(m, total_steps, epochs)  # (J, n_m, E, ...)
            pad = n_max - len(self.cluster_members[m])
            if pad:
                b = {k: np.concatenate([a, np.repeat(a[:, :1], pad, axis=1)], axis=1)
                     for k, a in b.items()}
            per_cluster.append(b)
        return self._to_device({k: np.stack([b[k] for b in per_cluster], axis=1)
                                for k in per_cluster[0]})

    def padded_cluster_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(gammas, mask), both (M, n_max) on the device: per-cluster client
        weights padded with zeros, and a 1/0 mask of real client slots."""
        n_max = max(len(members) for members in self.cluster_members)
        gammas = np.zeros((self.num_clusters, n_max), np.float32)
        mask = np.zeros((self.num_clusters, n_max), np.float32)
        for m in range(self.num_clusters):
            w = self.cluster_weights(m)
            gammas[m, : len(w)] = w
            mask[m, : len(w)] = 1.0
        return torch.from_numpy(gammas).to(self.device), torch.from_numpy(mask).to(self.device)

    def init_params(self) -> Tree:
        return self.fed_model.init(self.seed, self.device)

    def num_params(self) -> int:
        return tree_num_params(self.init_params())

    def param_leaf_sizes(self) -> tuple[int, ...]:
        """Per-leaf entry counts of the params, in leaf order — what a wire
        channel needs to price a message exactly."""
        return tuple(leaf.numel() for leaf in tree_leaves(self.init_params()))

    def evaluate(self, params: Tree) -> float:
        return self.fed_model.eval_metric(params, self.source.eval_data())


@dataclasses.dataclass
class RunRecorder:
    """The eval/log tail: `record(t, params, losses)` appends to the logs iff
    t is an eval round (t % eval_every == 0, or the final round).

    `obs` (`repro_torch.obs.RunTelemetry`) is the run's observability
    carrier: every evaluation runs in its "eval" span, and the telemetry
    rides out on `RunResult.telemetry`."""

    task: FLTask
    rounds: int
    eval_every: int
    obs: Any = None
    rounds_log: list = dataclasses.field(default_factory=list)
    acc_log: list = dataclasses.field(default_factory=list)
    loss_log: list = dataclasses.field(default_factory=list)

    def should_eval(self, t: int) -> bool:
        return t % self.eval_every == 0 or t == self.rounds - 1

    def record(self, t: int, params: Tree, losses) -> None:
        if not self.should_eval(t):
            return
        self.rounds_log.append(t)
        with maybe_span(self.obs, "eval"):
            self.acc_log.append(self.task.evaluate(params))
        self.loss_log.append(float("nan") if losses is None else float(torch.mean(losses)))

    def result(self, name: str, ledger: CommLedger, params: Tree) -> RunResult:
        return RunResult(name, self.rounds_log, self.acc_log, self.loss_log, ledger,
                         params, metric_mode=self.task.metric_mode, telemetry=self.obs)


@dataclasses.dataclass
class RunResult:
    name: str
    rounds: list[int]
    test_acc: list[float]  # the task metric per eval round
    train_loss: list[float]
    ledger: CommLedger
    final_params: Tree
    metric_mode: str = "max"
    telemetry: Any = None          # the run's RunTelemetry, when it carried one
    sim_times: list | None = None  # simulated seconds at each eval: set by the
    #   event-driven async drivers (repro_torch.async_fl), whose runs execute
    #   on a simulated clock instead of replaying one after the fact

    def _empty_metric(self) -> float:
        # an empty log reads as worst-possible in the metric's direction
        return 0.0 if self.metric_mode == "max" else float("inf")

    def best_acc(self) -> float:
        if not self.test_acc:
            return self._empty_metric()
        return max(self.test_acc) if self.metric_mode == "max" else min(self.test_acc)

    def final_acc(self) -> float:
        """The last evaluated metric; worst-possible for an empty log."""
        return self.test_acc[-1] if self.test_acc else self._empty_metric()

    def _reached(self, value: float, gamma: float) -> bool:
        return value >= gamma if self.metric_mode == "max" else value <= gamma

    def rounds_to_accuracy(self, gamma: float) -> int | None:
        """First eval round where the metric crosses `gamma` (>= for "max"
        metrics, <= for "min" metrics such as perplexity)."""
        for r, a in zip(self.rounds, self.test_acc):
            if self._reached(a, gamma):
                return r
        return None

    def bits_to_accuracy(self, gamma: float) -> int | None:
        r = self.rounds_to_accuracy(gamma)
        return None if r is None else self.ledger.bits_until(r)

    def sim_time_to_accuracy(self, gamma: float) -> float | None:
        """First simulated second at which the metric crosses `gamma`; only
        runs that carry `sim_times` (the async drivers) have one."""
        if self.sim_times is None:
            return None
        for t_s, a in zip(self.sim_times, self.test_acc):
            if self._reached(a, gamma):
                return t_s
        return None


def evaluate(model, params: Tree, eval_data, batch: int = 512) -> float:
    """Scalar evaluation: the model's `eval_metric` over `eval_data` (for a
    classifier, test-set accuracy over a `Dataset`, batched at 512)."""
    del batch  # fixed inside ClassifierFedModel.eval_metric, as the reference's
    return as_fed_model(model).eval_metric(params, eval_data)
