"""Small shared utilities: tree helpers over dicts and lists (the tree
arithmetic of the reference's `repro/utils.py`), device resolution.

Parameters, gradients and messages are trees of tensors: nested dicts,
lists and tuples.  Leaves are visited in the order `jax.tree.flatten` gives
the same tree in the reference package (dict keys sorted, lists and tuples
in index order, an empty container has no leaves): per-leaf QSGD keys and
per-leaf message sizes depend on that order, so every helper here keeps it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.prng import split

Tree = Any  # nested dicts / lists / tuples of tensors (or a bare tensor)


def tree_flatten(tree: Tree) -> tuple[list, Any]:
    """Leaves in `jax.tree.flatten` order, plus the structure to rebuild the
    tree: None for a leaf, else (container type, keys, child structures,
    leaves per child)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        children = [tree[k] for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys, children = None, list(tree)
    else:
        return [tree], None
    leaves, defs, counts = [], [], []
    for child in children:
        sub, d = tree_flatten(child)
        leaves += sub
        defs.append(d)
        counts.append(len(sub))
    return leaves, (type(tree), keys, defs, counts)


def tree_unflatten(treedef: Any, leaves: list) -> Tree:
    if treedef is None:
        return leaves[0]
    kind, keys, defs, counts = treedef
    children, i = [], 0
    for d, n in zip(defs, counts):
        children.append(tree_unflatten(d, leaves[i : i + n]))
        i += n
    if kind is dict:
        return dict(zip(keys, children))
    return kind(children)


def tree_leaves(tree: Tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, tree)


def tree_axpy(alpha, x: Tree, y: Tree) -> Tree:
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_weighted_sum(trees: list[Tree], weights) -> Tree:
    """sum_i weights[i] * trees[i], the ES aggregation of Eq. (5), summed in
    list order."""
    if not trees or len(trees) != len(weights):
        raise ValueError("tree_weighted_sum needs one weight per tree, and a tree")
    acc = tree_scale(trees[0], weights[0])
    for t, w in zip(trees[1:], weights[1:]):
        acc = tree_axpy(w, t, acc)
    return acc


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """sum over leaves of <a, b>, a 0-dim tensor."""
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    return tree_dot(tree, tree)


def tree_num_params(tree: Tree) -> int:
    return int(sum(leaf.numel() for leaf in tree_leaves(tree)))


def tree_num_bytes(tree: Tree) -> int:
    return int(sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree)))


def tree_any_nan(tree: Tree) -> bool:
    return any(bool(torch.isnan(leaf).any()) for leaf in tree_leaves(tree))


def split_like(key: np.ndarray, tree: Tree) -> Tree:
    """One key (uint32 key words) per leaf, in the tree's structure: the
    words of `jax.random.split(key, n_leaves)`."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, list(split(key, len(leaves))))


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU.  With no card and no explicit device they raise: there is no
    silent CPU fallback.  On the card, float32 products and convolutions are
    held to full float32 (no TF32), and cuDNN to deterministic algorithms,
    so a same-seed run repeats bit for bit on one card as the reference's
    do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain CPU path")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    return device


# --------------------------------------------------------------------------
# named scopes: the phases that the roofline's counting mode bills ops to
# --------------------------------------------------------------------------

SCOPES: list[str] = []


@contextlib.contextmanager
def named_scope(name: str):
    """Tag the ops run inside the block with `name` (the port's
    `jax.named_scope`): a plain Python name stack, read only by
    `repro_torch.roofline`'s counting mode (`phase_bytes`).  It launches
    nothing and changes no result."""
    SCOPES.append(name)
    try:
        yield
    finally:
        SCOPES.pop()
