"""Checkpointing: parameter trees and resumable FL run state (port of
`repro/checkpoint/io.py`, in the reference's on-disk format).

npz-based: leaves are stored under their tree paths, so a checkpoint is
stable across process restarts, readable with plain numpy, and a file
either package writes loads in the other.

Two layers:

  * `save_pytree` / `load_pytree` — one tree of tensors (or numpy arrays)
    per npz file.  Each leaf is keyed by its path (dict key or sequence
    index, joined by "/") in `jax.tree.flatten` order, beside a
    `__pytree_meta__` record: the leaf order, the tree structure in JAX's
    `PyTreeDef(...)` notation (dicts, lists, tuples and None; None is an
    empty node, as in JAX) and the true dtype of every 16- or 8-bit float
    leaf, which is stored as its same-width unsigned bit pattern: the round
    trip is bit-exact.  `load_pytree` verifies the order, the structure and
    every shape against the `like` tree, names the leaf in every error, and
    puts each leaf on the device of its `like` leaf, in its dtype.
  * `save_run_state` / `load_run_state` — a whole resumable run: a tree of
    arrays (params, optimizer stacks, buffered deltas, key words) plus a
    JSON meta sidecar (cursors, draw counts, ledger state, recorder logs).
    Both writes are atomic (a tmp file, then `os.replace`), and the meta
    sidecar is written last, so its presence certifies a complete
    checkpoint: a process killed mid-save leaves the previous checkpoint or
    the new one, never a torn one.

`save_fl_state` / `load_fl_state` are the reference's round-granular
Fed-CHS helpers.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

Tree = Any
PyTree = Tree  # the reference's name
_META_KEY = "__pytree_meta__"

# float leaves numpy cannot hold (or holds only through the reference's
# ml_dtypes): stored as the same-width unsigned bit pattern, true dtype in
# the meta.  name -> (numpy storage, the same-width torch integer, the dtype)
_BITCAST = {
    "bfloat16": (np.uint16, torch.int16, torch.bfloat16),
    "float16": (np.uint16, torch.int16, torch.float16),
    "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn),
}
_INT_OF = {torch.int16: np.int16, torch.uint8: np.uint8}


def _flatten_with_path(tree: Tree, path: tuple = ()) -> tuple[list, str]:
    """[(path, leaf)] in `jax.tree.flatten` order (dict keys sorted, lists
    and tuples by index, None an empty node), and the structure as
    `str(jax.tree.structure(tree))` prints it, without "PyTreeDef(...)"."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        flat, parts = [], []
        for k in sorted(tree):
            sub, d = _flatten_with_path(tree[k], path + (k,))
            flat += sub
            parts.append(f"{k!r}: {d}")
        return flat, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        flat, parts = [], []
        for i, child in enumerate(tree):
            sub, d = _flatten_with_path(child, path + (i,))
            flat += sub
            parts.append(d)
        if isinstance(tree, list):
            return flat, "[" + ", ".join(parts) + "]"
        return flat, "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    return [(path, tree)], "*"


def treedef_str(tree: Tree) -> str:
    """The tree's structure in JAX's notation, e.g.
    ``PyTreeDef({'b': (*, None), 'w': [*]})``."""
    return f"PyTreeDef({_flatten_with_path(tree)[1]})"


def _unflatten(tree: Tree, leaves: list) -> Tree:
    """`tree`'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(tree)


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(name: str, leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as a numpy array, and its true dtype where the array holds
    its bit pattern."""
    if isinstance(leaf, torch.Tensor):
        dt = str(leaf.dtype).removeprefix("torch.")
        if dt in _BITCAST:
            store, view, _ = _BITCAST[dt]
            return leaf.detach().view(view).cpu().numpy().view(store), dt
        return leaf.detach().cpu().numpy(), None
    arr = np.asarray(leaf)
    dt = str(arr.dtype)
    if arr.dtype.kind == "V" or dt in _BITCAST:
        if dt not in _BITCAST:
            raise TypeError(f"cannot serialise leaf {name!r} of dtype {dt}")
        return arr.view(_BITCAST[dt][0]), dt
    return arr, None


def _atomic_replace(tmp: str, dst: str) -> None:
    os.replace(tmp, dst)


def save_pytree(path: str, tree: Tree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat, structure = _flatten_with_path(tree)
    arrays, order, dtypes = {}, [], {}
    for keypath, leaf in flat:
        name = _path_str(keypath)
        order.append(name)
        arrays[name], dt = _to_numpy(name, leaf)
        if dt is not None:
            dtypes[name] = dt
    meta = {"order": order, "treedef": f"PyTreeDef({structure})", "dtypes": dtypes}
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    _atomic_replace(tmp, path)


def _read_meta(data, path: str) -> dict | None:
    if _META_KEY not in data:
        return None
    try:
        return json.loads(bytes(data[_META_KEY]).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: corrupt {_META_KEY} record: {e}") from e


def _from_numpy(arr: np.ndarray, stored_dt: str | None, like):
    """A stored array as a leaf like `like`: a tensor on its device in its
    dtype, or a numpy array in its dtype.  A bit-pattern leaf is viewed
    back to its true dtype first, so a cast starts from the true values."""
    is_tensor = isinstance(like, torch.Tensor)
    if stored_dt is None:
        if not is_tensor:
            return arr.astype(np.asarray(like).dtype)
        t = torch.as_tensor(arr)
    else:
        _, as_int, dtype = _BITCAST[stored_dt]
        t = torch.from_numpy(arr.view(_INT_OF[as_int])).view(dtype)
    if is_tensor:
        return t.to(dtype=like.dtype).to(like.device)
    want = np.asarray(like).dtype
    return t.to(torch.from_numpy(np.zeros(0, want)).dtype).numpy()


def load_pytree(path: str, like: Tree) -> Tree:
    """Restore into the structure of `like`.

    The stored `__pytree_meta__` (leaf order + treedef) is verified against
    `like`: a structure mismatch raises instead of mapping leaves onto the
    wrong ones; a missing leaf or a shape mismatch names the leaf and the
    file."""
    with np.load(path) as data:
        flat, structure = _flatten_with_path(like)
        treedef = f"PyTreeDef({structure})"
        order = [_path_str(kp) for kp, _ in flat]
        meta = _read_meta(data, path)
        if meta is not None:
            if meta.get("order") != order:
                stored, want = meta.get("order", []), order
                missing = [n for n in want if n not in stored]
                extra = [n for n in stored if n not in want]
                raise ValueError(
                    f"{path}: checkpoint leaf order does not match the requested "
                    f"structure (stored {len(stored)} leaves, want {len(want)}; "
                    f"missing={missing[:5]}, unexpected={extra[:5]})")
            if meta.get("treedef") != treedef:
                raise ValueError(f"{path}: checkpoint treedef mismatch — stored "
                                 f"{meta.get('treedef')!r}, want {treedef!r}")
        leaves = []
        for (_, leaf), name in zip(flat, order):
            if name not in data:
                raise KeyError(
                    f"{path}: checkpoint has no leaf {name!r} (available: "
                    f"{sorted(k for k in data.files if k != _META_KEY)[:8]}...)")
            arr = data[name]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{path}: leaf {name!r} has shape {arr.shape}, "
                                 f"want {tuple(leaf.shape)}")
            leaves.append(_from_numpy(arr, (meta or {}).get("dtypes", {}).get(name), leaf))
        return _unflatten(like, leaves)


# --------------------------------------------------------------------------
# resumable run state: arrays npz + JSON meta sidecar
# --------------------------------------------------------------------------


def save_run_state(path: str, arrays: Tree, meta: dict) -> None:
    """Save one resumable run checkpoint: `arrays` any tree of tensors or
    arrays, `meta` a JSON-serialisable dict.  Both writes are atomic; the
    meta is written last, so its presence certifies a complete checkpoint."""
    save_pytree(path + ".arrays.npz", arrays)
    tmp = path + ".meta.json.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(meta, f)
    _atomic_replace(tmp, path + ".meta.json")


def read_run_meta(path: str) -> dict:
    """The meta sidecar of a `save_run_state` checkpoint."""
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{meta_path}: no complete checkpoint at {path!r} (meta sidecar "
            "missing — the run was never checkpointed or the save was "
            "interrupted before the arrays finished)")
    with open(meta_path) as f:
        return json.load(f)


def load_run_state(path: str, like_arrays: Tree) -> tuple[Tree, dict]:
    """Load a `save_run_state` checkpoint; returns ``(arrays, meta)``."""
    meta = read_run_meta(path)
    return load_pytree(path + ".arrays.npz", like_arrays), meta


def run_state_exists(path: str) -> bool:
    return os.path.exists(path + ".meta.json")


# --------------------------------------------------------------------------
# the reference's round-state helpers
# --------------------------------------------------------------------------


def save_fl_state(path: str, params: Tree, *, round_idx: int, visit_counts: np.ndarray,
                  current: int) -> None:
    """Round-resumable Fed-CHS state: model + scheduler (c vector, m(t))."""
    save_pytree(path + ".params.npz", params)
    np.savez(path + ".sched.npz", round_idx=np.int64(round_idx),
             visit_counts=visit_counts.astype(np.int64), current=np.int64(current))


def load_fl_state(path: str, like_params: Tree):
    params = load_pytree(path + ".params.npz", like_params)
    with np.load(path + ".sched.npz") as s:
        return params, int(s["round_idx"]), s["visit_counts"].copy(), int(s["current"])
