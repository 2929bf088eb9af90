"""PyTorch/CUDA port of the Fed-CHS reproduction (reference: the `repro` package).

Imports torch and numpy only, never jax and nothing of `repro`.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""
