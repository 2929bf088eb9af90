"""Synthetic datasets, Dirichlet partitions and per-client batch sources."""
