"""Hopper CUDA kernels (QSGD, flash attention), their plain torch versions,
their build, and the QSGD leaf and tree wrappers."""
