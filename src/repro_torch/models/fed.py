"""FedModel adapters (port of `repro/models/fed.py`).

A FedModel (the `FedModel` protocol) is what the round engine sees of the
task: parameter init, the loss of one batch tree, and the held-out metric.

  * `ClassifierFedModel` — the Appendix-A classifiers; batches are
    ``{"x": images, "y": labels}`` and the metric is test-set accuracy.
  * `LMFedModel` — a decoder transformer LM from `configs.ArchConfig` +
    `models.transformer`; batches are ``{"tokens", "labels"}`` and the
    metric is held-out perplexity (lower is better).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.loader import batch_iterator
from repro_torch.models import transformer as tf
from repro_torch.models.classifier import Classifier
from repro_torch.utils import resolve_device, tree_leaves

Tree = Any
Batch = Any


@runtime_checkable
class FedModel(Protocol):
    """What the FL core needs from a workload."""

    name: str
    metric_name: str  # e.g. "accuracy", "perplexity"
    metric_mode: str  # "max" (accuracy-like) or "min" (loss-like)

    def init(self, seed: int = 0, device=None) -> Tree:
        """Fresh parameter tree on `device`."""
        ...

    def loss(self, params: Tree, batch: Batch) -> torch.Tensor:
        """Scalar training loss of one mini-batch tree."""
        ...

    def eval_metric(self, params: Tree, eval_data: Any) -> float:
        """Scalar quality metric on held-out data."""
        ...


@dataclasses.dataclass(frozen=True)
class ClassifierFedModel:
    """Appendix-A MLP/LeNet as a FedModel; batch = {"x": images, "y": labels}."""

    clf: Classifier
    metric_name: str = dataclasses.field(default="accuracy", init=False)
    metric_mode: str = dataclasses.field(default="max", init=False)

    @property
    def name(self) -> str:
        return self.clf.name

    def init(self, seed: int = 0, device=None) -> Tree:
        return self.clf.init(seed, device)

    def loss(self, params: Tree, batch: Batch) -> torch.Tensor:
        return self.clf.loss(params, batch["x"], batch["y"])

    def eval_metric(self, params: Tree, eval_data) -> float:
        """Test-set accuracy over `eval_data` (a `data.synthetic.Dataset`),
        batched at 512 on the params' device."""
        device = tree_leaves(params)[0].device
        n_correct, n = 0, 0
        with torch.no_grad():
            for x, y in batch_iterator(eval_data.test_x, eval_data.test_y, 512):
                logits = self.clf.apply(params, torch.from_numpy(x).to(device))
                pred = torch.argmax(logits, dim=-1)
                n_correct += int((pred == torch.from_numpy(y).to(device)).sum())
                n += len(y)
        return n_correct / max(n, 1)


@dataclasses.dataclass(frozen=True)
class LMFedModel:
    """Decoder transformer LM as a FedModel.

    Batch = {"tokens": (B, T) int32, "labels": (B, T) int32}; the loss is
    `models.transformer.loss_fn`, the next-token cross entropy plus a MoE
    model's router aux loss, and the metric exp(mean loss) over a fixed
    held-out batch set, aux included, as the reference's.  `flash` routes
    self-attention through the flash-attention kernel (sets
    `cfg.use_flash`); `remat` recomputes each superblock in the backward
    pass instead of keeping its activations (`transformer.RematBlock`).
    With both on, and the engine's `client_microbatch` and `precision`, this
    is the memory-lean LM training configuration.  An encoder-decoder's
    batches also carry "frames" (B, F, d), a VLM's "patches" (B, P, 1024),
    as the reference's do."""

    cfg: ArchConfig
    remat: bool = False
    flash: bool = False

    metric_name: str = dataclasses.field(default="perplexity", init=False)
    metric_mode: str = dataclasses.field(default="min", init=False)

    @property
    def name(self) -> str:
        return f"lm-{self.cfg.name}"

    def _run_cfg(self) -> ArchConfig:
        if self.flash and not self.cfg.use_flash:
            return dataclasses.replace(self.cfg, use_flash=True)
        return self.cfg

    def init(self, seed: int = 0, device=None) -> Tree:
        return tf.init_params(self.cfg, seed, resolve_device(device))

    def loss(self, params: Tree, batch: Batch) -> torch.Tensor:
        return tf.loss_fn(self._run_cfg(), params, batch, remat=self.remat)

    def eval_metric(self, params: Tree, eval_data) -> float:
        """exp(mean next-token CE) over `eval_data`: a batch dict with a
        leading eval-batch axis on every leaf (numpy), one forward each."""
        device = tree_leaves(params)[0].device
        n = len(next(iter(eval_data.values())))
        with torch.no_grad():
            losses = [self.loss(params, {k: torch.from_numpy(np.ascontiguousarray(a[i]))
                                         .to(device) for k, a in eval_data.items()})
                      for i in range(n)]
            return float(torch.exp(torch.stack(losses).mean()))


def as_fed_model(model):
    """Raw `Classifier`s get wrapped; FedModels (`LMFedModel` included) pass
    through."""
    if isinstance(model, Classifier):
        return ClassifierFedModel(model)
    return model
