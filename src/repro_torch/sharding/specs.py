"""Partition rules (port of `repro/sharding/specs.py`): which dims of a
parameter, batch, cache or engine tree are split over which mesh axes.

These are host functions over the port's trees.  A spec is a
`PartitionSpec`: a tuple with one entry per leading dim of the leaf, each
an axis name, a tuple of axis names, or None (not split); trailing dims it
does not name are not split.  The tensor-parallel convention (the "model"
axis):

  * column-parallel in-projections (wq/wk/wv, FFN in/gate, SSD/LRU
    in-proj): (None, "model"), output features split;
  * row-parallel out-projections (wo, FFN out): ("model", None);
  * MoE expert tensors (E, d, f): experts split on "model";
  * embedding (V, d) and lm_head (d, V): (None, "model");
  * 1-D vectors (norm scales, biases, decay rates): not split.

Leaves with extra leading dims (stacked superblocks, a Fed-CHS chain dim)
get Nones in front.  A mesh is anything with `axis_names` and a `shape`
mapping of axis name to size.

`named_shardings(mesh, specs)` turns a spec tree into `NamedSharding`s on
a model mesh (`launch.mesh.ModelMesh`), whose `placements` are DTensor's;
`distribute(tree, shardings)` lays a tree of tensors out as DTensors by
them.
"""
from __future__ import annotations

from typing import Any

Tree = Any
PyTree = Tree  # the reference's name

_ROW_PARALLEL = {"wo", "w_out"}
_COL_PARALLEL = {
    "wq", "wk", "wv", "w_gate", "w_in", "wq_b", "wkv_b", "w_x", "w_r", "w_i",
    "conv_w", "projector", "lm_head", "embed", "proj", "wq_a", "wkv_a",
}


class PartitionSpec(tuple):
    """The port's partition spec: ``PartitionSpec(None, "model")`` is the
    tuple ``(None, "model")``.  A one-axis tuple entry reads as that axis's
    name, as the reference's specs read."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _map_with_path(fn, tree: Tree, path: tuple = ()) -> Tree:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_name(path) -> str:
    last = path[-1]
    return last if isinstance(last, str) else f"[{last}]"


def _in_moe_ffn(path) -> bool:
    return "ffn" in [p for p in path if isinstance(p, str)]


def _base_spec(path, leaf, num_experts: int, expert_axis: str = "model") -> PartitionSpec:
    """Trailing-dims spec of the logical parameter (stacking dims excluded)."""
    name = _leaf_name(path)
    if leaf.ndim <= 1:
        return P()
    if (num_experts and _in_moe_ffn(path) and name in ("w_gate", "w_in", "w_out")
            and leaf.ndim >= 3 and leaf.shape[-3] == num_experts):
        ax = ("data", "model") if expert_axis == "both" else expert_axis
        return P(ax, None, None)  # expert parallel (E, d, f)
    if name in _ROW_PARALLEL:
        return P("model", None)
    if name in _COL_PARALLEL:
        return P(None, "model")
    return P(None, None)


def param_pspecs(params: Tree, *, num_experts: int = 0, mesh=None,
                 expert_axis: str = "model") -> Tree:
    """A spec tree matching `params`, aligned to each leaf's trailing dims;
    leading stacking dims are not split.  With `mesh`, a split dim that its
    axes do not divide is not split (e.g. vocab 50280 on a 16-way model
    axis)."""

    def spec(path, leaf):
        base = _base_spec(path, leaf, num_experts, expert_axis)
        extra = leaf.ndim - len(base)
        if extra > 0:
            base = P(*([None] * extra), *base)
        elif extra < 0:
            base = P(*base[-leaf.ndim:]) if leaf.ndim else P()
        if mesh is not None:
            dims = []
            for i, ax in enumerate(base):
                if ax is None:
                    dims.append(None)
                    continue
                n = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    n *= mesh.shape[a]
                dims.append(ax if leaf.shape[i] % n == 0 else None)
            base = P(*dims)
        return base

    return _map_with_path(spec, params)


def batch_pspec(batch_size: int, mesh, rank: int = 2) -> PartitionSpec:
    """Split the batch dim over as many data-like axes as divide it."""
    use, div = [], 1
    for a in [a for a in ("pod", "data") if a in mesh.axis_names]:
        n = mesh.shape[a]
        if batch_size % (div * n) == 0:
            use.append(a)
            div *= n
    return P(tuple(use) if use else None, *([None] * (rank - 1)))


def cache_pspecs(caches: Tree, batch_size: int, mesh) -> Tree:
    """KV and state caches: the batch dim split like the batch, kv-head or
    state dims on "model" where they divide, a stacked leading dim not
    split.  Layouts: attn k/v (L?, B, S, Hkv, hd); mla c_kv (L?, B, S, r)
    and k_rope (L?, B, S, rope), both split on S (the reference splits
    c_kv only: the port's MLA decode scores its share of the positions
    against both, `attention._mla_decode_seq_split`);
    ssd state (L?, B, H, P, N); conv (L?, B, K, C); rglru h (L?, B, W);
    len (L?, B)."""
    baxes = batch_pspec(batch_size, mesh, rank=1)[0]
    n_model = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def spec(path, leaf):
        name = _leaf_name(path)
        dims: list = [None] * leaf.ndim
        bdim = None
        for i, s in enumerate(leaf.shape):  # the batch dim: the first of its size
            if s == batch_size:
                dims[i] = baxes
                bdim = i
                break
        if name in ("k", "v") and leaf.ndim >= 4:
            hkv = leaf.shape[-2]
            sdim = leaf.ndim - 3
            if n_model > 1 and hkv % n_model == 0:
                dims[-2] = "model"  # kv-head parallel
            elif n_model > 1 and leaf.shape[sdim] % n_model == 0 and sdim != bdim:
                dims[sdim] = "model"  # sequence-parallel cache
        elif name in ("c_kv", "k_rope") and leaf.ndim >= 3:
            sdim = leaf.ndim - 2
            if n_model > 1 and leaf.shape[sdim] % n_model == 0 and sdim != bdim:
                dims[sdim] = "model"
        elif name in ("state", "h", "conv", "cross_k", "cross_v"):
            tgt = leaf.ndim - 2 if name in ("cross_k", "cross_v") else leaf.ndim - 1
            if (n_model > 1 and leaf.shape[tgt] % n_model == 0
                    and leaf.shape[tgt] >= n_model and tgt != bdim):
                dims[tgt] = "model"
        return P(*dims)

    return _map_with_path(spec, caches)


class NamedSharding:
    """A spec on a model mesh (the port's `jax.sharding.NamedSharding`).
    `placements` has one DTensor placement per mesh dim, in the mesh's
    axis order: a spec entry naming axis `a` at tensor dim `i` is `Shard(i)`
    on `a`; a tuple entry ``("data", "model")`` is `Shard(i)` on both, which
    splits dim `i` data-major, model-minor as JAX does (device (d, m) holds
    chunk d * n_model + m), so its axes must come in mesh order; every
    other mesh dim is `Replicate()`."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.axis_names)
        out = [Replicate()] * len(names)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"{entry!r} splits dim {i} in another order than the mesh's "
                                 f"axes {names}")
            for d in dims:
                out[d] = Shard(i)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r}, {self.placements})"


def named_shardings(mesh, pspecs: Tree) -> Tree:
    """`NamedSharding(mesh, spec)` for every spec of the tree."""
    if isinstance(pspecs, PartitionSpec):
        return NamedSharding(mesh, pspecs)
    if isinstance(pspecs, dict):
        return {k: named_shardings(mesh, v) for k, v in pspecs.items()}
    if isinstance(pspecs, (list, tuple)):
        return type(pspecs)(named_shardings(mesh, v) for v in pspecs)
    raise TypeError(f"not a spec tree: {pspecs!r}")


def distribute(tree: Tree, shardings: Tree) -> Tree:
    """Every tensor of `tree` laid out on its sharding's mesh as a DTensor
    (`torch.distributed.tensor.distribute_tensor` with no source rank: each
    rank keeps its shard of the tensor it passes, so every rank must pass
    the same whole tensor, as ranks that draw from one seed do).  On a
    1-rank mesh the tree comes back as it is."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh):
        if sh.mesh.device_mesh is None:
            return t
        return distribute_tensor(t, sh.mesh.device_mesh, sh.placements, src_data_rank=None)

    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, sh) for v, sh in zip(tree, shardings))
    return one(tree, shardings)


# --------------------------------------------------------------------------
# the federation mesh: the whole-run engine's stacked trees
# --------------------------------------------------------------------------

FED_AXES = ("clusters", "clients")


def fed_engine_pspecs(kind: str) -> dict:
    """Specs of the engine's scan-body trees on a federation mesh, per body
    kind, keyed by the body's (carry, xs, ys) trees:

      * ``"grad"``: `scan_grad_body` (WRWGD walks, Fed-CHS Eq.-(5) mode).
        carry = params, on every rank; x["batch"] (K, n, B, ...) splits the
        flat client axis over both mesh axes.
      * ``"delta"``: `scan_delta_body` (FedAvg).  carry = (params,
        opt_state (n, ...)): params on every rank, opt rows split with the
        clients; x["batch"] (J, n, E, B, ...).
      * ``"cluster_delta"``: `scan_cluster_delta_body` (Fed-CHS delta mode).
        One cluster trains a round, so the opt stack's cluster axis
        (M, n, ...) is not split and its client axis is split over the
        whole mesh.
      * ``"multi"``: `scan_multi_body` (3-tier HFL): batch (J, M, n_max, E,
        B, ...) and opt (M, n_max, ...) split clusters over "clusters" and
        in-cluster clients over "clients".

    Schedule rows (gammas, mask, ES weights) and key chains are on every
    rank: the sharded bodies slice their own window, so the full-width
    aggregates see the unsharded operands.  The staged-xs trees add a
    leading chunk axis in front of the batch specs."""
    flat = P(FED_AXES)
    if kind == "grad":
        return {"carry": P(),
                "xs": {"batch": P(None, FED_AXES), "gammas": P(), "lrs": P()},
                "ys": P()}
    if kind == "delta":
        return {"carry": (P(), flat),
                "xs": {"batch": P(None, FED_AXES), "gammas": P(), "mask": P(), "subs": P()},
                "ys": P()}
    if kind == "cluster_delta":
        return {"carry": (P(), P(None, FED_AXES)),
                "xs": {"m": P(), "batch": P(None, FED_AXES), "gammas": P(), "mask": P(),
                       "subs": P()},
                "ys": P()}
    if kind == "multi":
        return {"carry": (P(), P("clusters", "clients")),
                "xs": {"batch": P(None, "clusters", "clients"), "gammas": P(), "mask": P(),
                       "es_weights": P(), "subs": P(), "es_subs": P()},
                "ys": P()}
    raise ValueError(f"unknown engine scan-body kind: {kind!r}")
