"""Small shared utilities: nested-dict tree helpers, device resolution.

Parameters, gradients and messages are nested dicts of tensors.  Leaves are
always visited in sorted-key order, the order `jax.tree.flatten` gives a
dict in the reference package: per-leaf QSGD keys and per-leaf message
sizes depend on that order, so every helper here keeps it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any  # nested dict of tensors (or a bare tensor)


def tree_flatten(tree: Tree) -> tuple[list, Any]:
    """Leaves in sorted-key order, plus the structure to rebuild the tree."""
    if isinstance(tree, dict):
        leaves, defs = [], []
        for k in sorted(tree):
            sub, d = tree_flatten(tree[k])
            leaves += sub
            defs.append((k, d, len(sub)))
        return leaves, defs
    if isinstance(tree, tuple) and not tree:
        return [], ()
    return [tree], None


def tree_unflatten(treedef: Any, leaves: list) -> Tree:
    if treedef is None:
        return leaves[0]
    if treedef == ():
        return ()
    out, i = {}, 0
    for k, d, n in treedef:
        out[k] = tree_unflatten(d, leaves[i : i + n])
        i += n
    return out


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
