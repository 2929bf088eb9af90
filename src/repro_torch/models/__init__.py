"""Models: the Appendix-A classifiers (MLP, LeNet), the transformer LM, and
their FedModel adapters (the names `repro.models` exports)."""
from repro_torch.models.classifier import Classifier, make_classifier
from repro_torch.models.fed import ClassifierFedModel, FedModel, LMFedModel, as_fed_model

__all__ = [
    "Classifier",
    "make_classifier",
    "FedModel",
    "ClassifierFedModel",
    "LMFedModel",
    "as_fed_model",
]
