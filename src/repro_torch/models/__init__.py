"""Models: the Appendix-A classifiers (MLP, LeNet), the transformer LM, and
their FedModel adapters."""
