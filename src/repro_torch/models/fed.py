"""FedModel adapter for the Appendix-A classifiers (port of `repro/models/fed.py`).

`ClassifierFedModel` is what the round engine sees of the task: parameter
init, the loss of one batch ``{"x": images, "y": labels}`` and the test-set
accuracy.  The LM model is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.data.loader import batch_iterator
from repro_torch.models.classifier import Classifier
from repro_torch.utils import tree_leaves

Tree = Any
Batch = Any


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


def as_fed_model(model) -> ClassifierFedModel:
    """Raw `Classifier`s get wrapped; FedModels pass through."""
    if isinstance(model, Classifier):
        return ClassifierFedModel(model)
    return model
