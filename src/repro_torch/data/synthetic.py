"""Shape-faithful synthetic stand-ins for MNIST / CIFAR-10 / CIFAR-100.

The container has no network access, so we plant a learnable structure:
each class c has a smooth prototype image P_c; a sample is
x = clip(P_c + Gaussian noise). This keeps the paper's experimental axes
(dataset shapes, class counts, Dirichlet(λ) label skew, model families)
intact — only absolute accuracy values differ from the real datasets,
which DESIGN.md §6 records as a deviation.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    image_shape: tuple[int, int, int]  # H, W, C
    num_classes: int
    train_size: int
    test_size: int


DATASETS = {
    "mnist": DatasetSpec("mnist", (28, 28, 1), 10, 60_000, 10_000),
    "cifar10": DatasetSpec("cifar10", (32, 32, 3), 10, 50_000, 10_000),
    "cifar100": DatasetSpec("cifar100", (32, 32, 3), 100, 50_000, 10_000),
}


@dataclasses.dataclass
class Dataset:
    spec: DatasetSpec
    train_x: np.ndarray  # (N, H, W, C) float32 in [0, 1]
    train_y: np.ndarray  # (N,) int32
    test_x: np.ndarray
    test_y: np.ndarray


def _smooth_prototypes(rng: np.random.Generator, spec: DatasetSpec) -> np.ndarray:
    """Low-frequency class prototypes: random coefficients over a coarse 2-D
    cosine basis, so classes are separable but overlapping under noise."""
    h, w, c = spec.image_shape
    n_basis = 4
    ys = np.arange(h)[:, None] / h
    xs = np.arange(w)[None, :] / w
    basis = np.stack(
        [
            np.cos(np.pi * ky * ys) * np.cos(np.pi * kx * xs)
            for ky in range(n_basis)
            for kx in range(n_basis)
        ]
    )  # (n_basis^2, H, W)
    coef = rng.normal(size=(spec.num_classes, c, n_basis * n_basis))
    protos = np.einsum("kcb,bhw->khwc", coef, basis)
    # normalize to [0.2, 0.8] per class
    protos = protos - protos.min(axis=(1, 2, 3), keepdims=True)
    protos = protos / (protos.max(axis=(1, 2, 3), keepdims=True) + 1e-8)
    return (0.2 + 0.6 * protos).astype(np.float32)


def make_dataset(
    name: str,
    *,
    train_size: int | None = None,
    test_size: int | None = None,
    noise: float = 0.35,
    seed: int = 0,
) -> Dataset:
    spec = DATASETS[name]
    n_train = train_size if train_size is not None else spec.train_size
    n_test = test_size if test_size is not None else spec.test_size
    rng = np.random.default_rng(seed)
    protos = _smooth_prototypes(rng, spec)

    def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, spec.num_classes, size=n).astype(np.int32)
        x = protos[y] + rng.normal(scale=noise, size=(n, *spec.image_shape)).astype(np.float32)
        return np.clip(x, 0.0, 1.0).astype(np.float32), y

    train_x, train_y = sample(n_train)
    test_x, test_y = sample(n_test)
    return Dataset(spec, train_x, train_y, test_x, test_y)
