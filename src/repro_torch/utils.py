"""Small shared utilities: tree helpers over dicts and lists, device resolution.

Parameters, gradients and messages are trees of tensors: nested dicts,
lists and tuples.  Leaves are visited in the order `jax.tree.flatten` gives
the same tree in the reference package (dict keys sorted, lists and tuples
in index order, an empty container has no leaves): per-leaf QSGD keys and
per-leaf message sizes depend on that order, so every helper here keeps it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

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


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_num_params(tree: Tree) -> int:
    return int(sum(leaf.numel() for leaf in tree_leaves(tree)))


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
