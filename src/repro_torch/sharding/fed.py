"""Population-scale federation: the engine's client and cluster axes split
over a federation mesh of ranks (port of `repro/sharding/fed.py`).

The whole-run executor stacks every per-client quantity (batches,
optimizer states, masks, keys) on leading (clusters, clients) axes and
runs each round over them.  That layout is a data-parallel layout: this
module splits those axes over the ranks of a ``("clusters", "clients")``
`launch.mesh.FederationMesh`, one process per rank on `torch.distributed`.
The global params are on every rank; ranks talk only at aggregation
points, as all-gathers of the compressed uplinks.

Bit-parity contract
-------------------
A mesh run reproduces the single-device run of the same config: params,
eval metrics and the ledger equal bit for bit; train-loss log scalars
exact in grad mode and within rtol 1e-6 in the delta modes.  This holds
where local training does not depend on how many clients one vmap carries
(every MLP task on the CPU; a vmapped convolution is not lane-count
invariant there, so LeNet runs differ by about an ulp per step before any
collective runs).  The machinery itself keeps the width:

  * aggregation is not an all-reduce of partial sums, which would
    reassociate the gamma-weighted sum.  Each rank compresses its own
    senders' deltas (`RoundEngine._train_group`), the ranks all-gather the
    compressed messages (in rank order, which is global slot order), and
    every rank applies the same full-width tensordot the single-device
    round runs;
  * each sender's keys are those of its global slot: the plan stages every
    slot's per-leaf keys (`engine.uplink_keys`) and a rank takes its
    window of them;
  * client and cluster axes are padded to widths the mesh divides: padded
    slots carry zero gamma and zero mask (a zero delta, which every channel
    encodes to zero), and padded batch and key slots repeat slot 0 so their
    discarded training stays finite;
  * gathered stacks are cut back to the true width before every reduction,
    so it sees exactly the single-device operands.

The rounds are the engine's own: `shard_plan` builds the plan's
`engine.scan_*_body` with a `Split` of each axis the mesh splits
(`RoundEngine.client_split`, `cluster_split`), which gives each round its
window of the mask and gathers its stacks before the engine's reductions.
A round's collectives go through the host (gloo), which a CUDA graph
cannot capture, so a mesh plan runs its chunks eagerly
(`ScanPlan.chunk_fn`, `engine._ChunkRounds`).  With ``mesh=None`` the
drivers never reach this module.

Axis mapping
------------
  * FedAvg, Fed-CHS: one cluster trains per round, so the flat client axis
    is split over both mesh axes.
  * Hier-Local-QSGD: clusters over "clusters", clients within a cluster
    over "clients"; the in-cluster aggregate gathers over "clients" only,
    the ES->PS hop over "clusters" only.
  * WRWGD (n = 1): the walk's one client pads to the mesh width with
    zero-gamma slots (the same step on every rank, exact result).

Precision: the reference's sharded bodies build their local steps without
the policy's compute casts, so a mesh run under a `Precision` trains in
the master dtype with the policy's channel; the optimizer state keeps the
compute dtype it was made in, and a stateful optimizer whose state the
round promotes raises the TypeError the reference's scan raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.engine import (ScanPlan, scan_cluster_delta_body, scan_delta_body,
                                     scan_grad_body, scan_multi_body)
from repro_torch.data.sources import put_sharded
from repro_torch.sharding.ctx import current_mesh
from repro_torch.sharding.specs import FED_AXES, fed_engine_pspecs
from repro_torch.utils import tree_leaves, tree_map

Tree = Any


def resolve_mesh(mesh):
    """The federation mesh a driver shards over, or None.

    An explicit ``config.mesh`` wins; otherwise the ambient mesh
    (`sharding.ctx.model_mesh`) if its axes are exactly ``("clusters",
    "clients")``: a mesh of other axes is never adopted.  A 1-rank mesh
    resolves to None, the single-device run."""
    if mesh is None:
        amb = current_mesh()
        if amb is not None and tuple(amb.axis_names) == FED_AXES:
            mesh = amb
    if mesh is None:
        return None
    assert tuple(mesh.axis_names) == FED_AXES, (
        f"federation mesh must have axes {FED_AXES}, got {tuple(mesh.axis_names)}")
    return mesh if mesh.size > 1 else None


# --------------------------------------------------------------------------
# padding: client and cluster axes grow to widths the mesh divides
# --------------------------------------------------------------------------


def _ceil_to(n: int, q: int) -> int:
    return -(-n // q) * q


def _pad_np(a: np.ndarray, axis: int, to: int, *, edge0: bool) -> np.ndarray:
    """Pad `a` to width `to` along `axis`: zeros (gammas, masks, weights) or
    copies of index 0 (batches, keys: padded slots stay finite)."""
    pad = to - a.shape[axis]
    if pad <= 0:
        return a
    if edge0:
        return np.concatenate([a, np.take(a, np.zeros(pad, np.intp), axis=axis)], axis=axis)
    width = [(0, 0)] * a.ndim
    width[axis] = (0, pad)
    return np.pad(a, width)


def _pad_leaf(a: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """A device tensor padded with copies of index 0 along `axis` (optimizer
    rows: padded slots are masked, so they stay as they are)."""
    pad = to - a.shape[axis]
    if pad <= 0:
        return a
    first = a.narrow(axis, 0, 1)
    return torch.cat([a, first.expand(a.shape[:axis] + (pad,) + a.shape[axis + 1:])], axis)


# --------------------------------------------------------------------------
# the split of a slot axis, and the chunk the mesh runs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Split:
    """A round's slot axis laid over the mesh `axes` (`RoundEngine.client_split`,
    `cluster_split`).  The whole axis, padded to a width the axes divide,
    is staged on every rank; the rank trains its `window` of it; `width`
    is the true width, which `true` cuts a whole stack to and `gather`
    cuts the all-gathered stack to, so every reduction sees exactly the
    single-device operands."""

    mesh: Any
    axes: Any
    width: int

    def window(self, a: torch.Tensor, dim: int = 0) -> torch.Tensor:
        n = a.shape[dim] // self.mesh.axis_size(self.axes)
        return a.narrow(dim, self.mesh.axis_index(self.axes) * n, n)

    def true(self, a: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return a.narrow(dim, 0, self.width)

    def gather(self, tree: Tree, dim: int = 0) -> Tree:
        return tree_map(lambda t: t.narrow(dim, 0, self.width).contiguous(),
                        self.mesh.all_gather(tree, self.axes, dim))


def _body(kind: str, model, channel, es_channel, opt, mesh, clusters: int | None,
          clients: int):
    """The engine's scan body of `kind` on `mesh`'s splits, built without a
    `Precision` policy, as the reference's sharded bodies are."""
    if kind == "multi":
        return scan_multi_body(model, channel, es_channel, opt,
                               client_split=Split(mesh, "clients", clients),
                               cluster_split=Split(mesh, "clusters", clusters))
    split = Split(mesh, FED_AXES, clients)
    if kind == "grad":
        return scan_grad_body(model, client_split=split)
    if kind == "delta":
        return scan_delta_body(model, channel, opt, client_split=split)
    if kind == "cluster_delta":
        return scan_cluster_delta_body(model, channel, opt, client_split=split)
    raise ValueError(f"unknown engine scan-body kind: {kind!r}")


def _rounds(body):
    """A plan's chunk (`ScanPlan.chunk_fn`): `body` over every round of a
    chunk of device inputs, eagerly."""

    def chunk(carry, xs, consts):
        losses = None
        for c in range(len(tree_leaves(xs)[0])):
            carry, losses = body(carry, tree_map(lambda a, c=c: a[c], xs), consts)
        return carry, losses

    return chunk


# --------------------------------------------------------------------------
# plan rewriting
# --------------------------------------------------------------------------


def _window(spec, mesh, widths: dict) -> tuple:
    """This rank's index into a leaf split as `spec` over its leading dims:
    each split dim cut to this rank's equal part of its padded width
    ``widths[axes]``."""
    index = []
    for axes in spec:
        if axes is None:
            index.append(slice(None))
        else:
            n, i = widths[axes] // mesh.axis_size(axes), mesh.axis_index(axes)
            index.append(slice(i * n, (i + 1) * n))
    return tuple(index)


def shard_plan(plan: ScanPlan, mesh, kind: str, *, model, channel=None, es_channel=None,
               opt=None, clients: int, clusters: int | None = None,
               lrs: np.ndarray | None = None) -> ScanPlan:
    """Rewrite a single-device `ScanPlan` to run on `mesh`.

    Pads the client (and for "multi" the cluster) axes of the staged inputs
    and of the carry to widths the mesh divides, keeps this rank's window
    of the optimizer rows (params stay whole on every rank), and installs
    the engine's body of `kind` on the mesh's splits (`body`, run a chunk
    at a time by `chunk_fn`) and the per-rank put (`xs_put`); the
    schedule, the recording and the ledger glue are untouched.  Which dims
    are split, and over which axes, is `fed_engine_pspecs(kind)`'s.  The
    result equals running `plan` on one device (module docstring).  `lrs`,
    the delta modes' (J, E) step sizes, replaces the plan's consts with
    their float32 values: the mesh's bodies step in the master dtype, as
    the reference's do, also where a `Precision` policy made the plan's
    step sizes in its compute dtype."""
    assert plan.obs is None, "telemetry is per-host state — unsupported on a mesh"
    specs = fed_engine_pspecs(kind)
    device = tree_leaves(plan.carry)[0].device
    assert device == torch.device(mesh.device), \
        f"the run's device {device} is not the mesh rank's {mesh.device}"
    n_cl, n_ci = mesh.shape["clusters"], mesh.shape["clients"]
    if kind == "multi":
        assert clusters is not None
        M_pad, n_pad = _ceil_to(clusters, n_cl), _ceil_to(clients, n_ci)
        widths = {"clusters": M_pad, "clients": n_pad}
    else:
        n_pad = _ceil_to(clients, n_cl * n_ci)
        widths = {FED_AXES: n_pad}
    # the staged entries split over ranks (a leading chunk axis on each);
    # the per-sender keys lie as the batch does over their leading dims
    batch_spec = (None, *specs["xs"]["batch"])
    split = {"batch": batch_spec, "keys": batch_spec}
    if kind == "multi":
        split["es_keys"] = (None, "clusters")

    def pad_split(a, spec):  # copies of slot 0 in every split dim
        for d, axes in enumerate(spec):
            if axes is not None:
                a = _pad_np(a, d, widths[axes], edge0=True)
        return a

    stage0 = plan.stage

    def stage(idxs):
        xs = stage0(idxs)
        out = dict(xs)
        for k, spec in split.items():
            if k in xs:
                out[k] = tree_map(lambda a, spec=spec: pad_split(a, spec), xs[k])
        # the schedule rows every rank holds whole: zero gamma, mask and
        # weight in the padded slots
        if kind == "multi":
            for k in ("gammas", "mask"):
                out[k] = _pad_np(_pad_np(xs[k], 2, n_pad, edge0=False), 1, M_pad, edge0=False)
            out["es_weights"] = _pad_np(xs["es_weights"], 1, M_pad, edge0=False)
        else:
            for k in ("gammas", "mask"):
                if k in xs:
                    out[k] = _pad_np(xs[k], 1, n_pad, edge0=False)
        return out

    # carry: params whole on every rank; optimizer rows padded (copies of
    # slot 0, frozen by the mask) and cut to this rank's window
    carry = plan.carry
    if kind != "grad":
        params, opt_state = plan.carry
        opt_spec = specs["carry"][1]

        def rows(a):
            for d, axes in enumerate(opt_spec):
                if axes is not None:
                    a = _pad_leaf(a, d, widths[axes])
            return a[_window(opt_spec, mesh, widths)].contiguous()

        carry = (params, tree_map(rows, opt_state))

    consts = plan.consts
    if lrs is not None:
        consts = dict(consts, lrs=torch.as_tensor(np.asarray(lrs, np.float32), device=device))
    windows = {k: _window(spec, mesh, widths) for k, spec in split.items()}
    body = _body(kind, model, channel, es_channel, opt, mesh, clusters, clients)
    return dataclasses.replace(
        plan, body=body, stage=stage, carry=carry, consts=consts, chunk_fn=_rounds(body),
        xs_put=lambda xs: put_sharded(xs, windows, device))
