"""Appendix-A classifiers (MLP, LeNet) and the FedModel adapter."""
