"""QSGD wire kernels: Hopper CUDA kernels, plain torch versions, tree wrappers."""
