"""The federation mesh (port of `make_federation_mesh` in
`repro/launch/mesh.py`), on `torch.distributed`.

One process is one rank; the caller starts the ranks and initializes the
default process group (`torch.distributed.init_process_group` with its
address, world size and rank).  `make_federation_mesh(clusters, clients)`
lays those ranks out as a ``("clusters", "clients")`` grid, row-major, on
a `torch.distributed.device_mesh.DeviceMesh`, and keeps its process
groups in a `FederationMesh` that the drivers take as ``config.mesh``
(`repro_torch.sharding.fed`).  With fewer ranks than asked for it logs the
reference's warning and returns a 1-rank mesh that needs no process group:
a run on it is the single-device run, on the same device.

`spawn_ranks(fn, world)` runs ``fn(mesh_rank, *args)`` in `world` fresh
processes joined by a `gloo` group over a rendezvous file, and returns each
rank's result: a way to drive a mesh from one process, as the tests and the
card's smoke script do.  On one card every rank uses that card (NCCL takes
one rank per card; gloo serves CUDA tensors through the host).

The model meshes lay a model, not a federation, over the ranks:
`make_debug_mesh(data, model, pod)` and `make_production_mesh(multi_pod=)`
return a `ModelMesh` with the reference's axes ``("data", "model")`` or
``("pod", "data", "model")`` over a `DeviceMesh`, on which the step
builders (`launch.steps`) lay params and batches out as DTensors
(`sharding.specs.named_shardings`).  The production meshes need 256 or 512
ranks: outside a cluster they exist only inside `fake_world`, a fake
process group of that many ranks in one process, which is what the dry
run (`launch.dryrun`) lowers under.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import pickle
import tempfile
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import FED_AXES
from repro_torch.utils import resolve_device, tree_flatten, tree_leaves, tree_map, tree_unflatten

_log = logging.getLogger(__name__)


@dataclasses.dataclass(eq=False)
class FederationMesh:
    """A ``("clusters", "clients")`` grid of ranks.

    `shape` maps axis name to size, as the reference's `Mesh.shape` does;
    `coord` is this rank's (cluster, client) coordinate and `device` the
    device its tensors live on.  `group(axes)` is the process group along
    `axes` (both: every rank, row-major; one: the ranks that share the
    other coordinate), each created once when the mesh is made;
    `axis_index(axes)` this rank's index along them.  `all_gather` and
    `gather_lanes` are the collectives the sharded rounds and the sharded
    sweep run over those groups.  A 1-rank mesh holds no group."""

    shape: dict
    coord: tuple
    device: torch.device
    groups: dict = dataclasses.field(default_factory=dict)
    axis_names: tuple = FED_AXES

    @property
    def size(self) -> int:
        return self.shape["clusters"] * self.shape["clients"]

    @property
    def rank(self) -> int:
        """This rank's row-major index on the grid."""
        return self.coord[0] * self.shape["clients"] + self.coord[1]

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        assert set(axes) <= set(FED_AXES), axes
        return tuple(a for a in FED_AXES if a in axes)  # row-major order

    def axis_size(self, axes) -> int:
        n = 1
        for a in self._axes(axes):
            n *= self.shape[a]
        return n

    def axis_index(self, axes) -> int:
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coord[FED_AXES.index(a)]
        return idx

    def group(self, axes):
        return self.groups[self._axes(axes)]

    def all_gather(self, tree: Any, axes=FED_AXES, dim: int = 0) -> Any:
        """Every leaf all-gathered over `axes` and concatenated along `dim`
        in rank order, which is global slot order.  The list form of
        `dist.all_gather`, which gloo serves on CPU and CUDA tensors and
        NCCL serves too."""
        group, size = self.group(axes), self.axis_size(axes)

        def one(t):
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(size)]
            dist.all_gather(parts, t, group=group)
            return torch.cat(parts, dim)

        return tree_map(one, tree)

    def gather_lanes(self, tree: Any, stacked: bool = False) -> Any:
        """A sweep's lanes from every rank, in seed order.  `tree` is a
        tuple of this rank's lane carries (each leaf stacked, gathered and
        split back into lanes), or with `stacked` a tree whose leaves carry
        a leading lane axis (gathered along it)."""
        if stacked:
            return self.all_gather(tree)
        lanes = list(tree)
        leaves, treedef = tree_flatten(lanes[0])
        per_lane = [tree_leaves(lane) for lane in lanes]
        full = [self.all_gather(torch.stack([pl[i] for pl in per_lane]))
                for i in range(len(leaves))]
        return tuple(tree_unflatten(treedef, [f[k] for f in full])
                     for k in range(full[0].shape[0]))


def _single(device) -> FederationMesh:
    return FederationMesh({"clusters": 1, "clients": 1}, (0, 0), device)


def make_federation_mesh(clusters: int = 1, clients: int | None = None, *,
                         device=None) -> FederationMesh:
    """The population mesh for sharded FL runs: axes ``("clusters",
    "clients")`` over the ranks of the default process group.

    `clients=None` spreads the ranks left over across the client axis.
    Publish the mesh to the drivers explicitly (``config.mesh``) or through
    `repro_torch.sharding.ctx.model_mesh`.  `device` is this rank's device
    (the card unless the caller asks for the CPU).  With fewer ranks than
    the shape needs, the mesh falls back to 1 rank with a logged warning:
    a mesh=None run, never an error.  A mesh that leaves ranks out raises:
    every rank runs the driver."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if clients is None:
        clients = max(world // clusters, 1)
    n = clusters * clients
    if n > world:
        _log.warning(
            "federation mesh (clusters=%d, clients=%d) needs %d devices but only %d exist "
            "— falling back to a single-device mesh", clusters, clients, n, world)
        return _single(device)
    if n < world:
        raise ValueError(f"a federation mesh spans every rank: ({clusters}, {clients}) "
                         f"covers {n} of {world}")
    if n == 1:
        return _single(device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (clusters, clients), mesh_dim_names=FED_AXES)
    rank = dist.get_rank()
    groups = {FED_AXES: dist.group.WORLD,
              ("clusters",): dm.get_group("clusters"),
              ("clients",): dm.get_group("clients")}
    return FederationMesh({"clusters": clusters, "clients": clients},
                          (rank // clients, rank % clients), device, groups)


# --------------------------------------------------------------------------
# running a function on gloo ranks from one process
# --------------------------------------------------------------------------


def _rank_main(rank: int, world: int, init_file: str, out_dir: str, threads: int | None,
               fn: Callable, args: tuple) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank)
    try:
        result = fn(rank, *args)
        payload = ("ok", result)
    except BaseException as e:  # reported to the parent, which raises
        payload = ("error", f"rank {rank}: {type(e).__name__}: {e}\n{traceback.format_exc()}")
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)
    if payload[0] == "ok":
        dist.barrier()
    dist.destroy_process_group()
    if payload[0] != "ok":
        raise SystemExit(1)


def spawn_ranks(fn: Callable, world: int, *args, threads: int | None = None,
                tmp_dir: str | None = None) -> list:
    """``fn(rank, *args)`` on `world` spawned processes that share a `gloo`
    process group (rendezvous through a file in a temporary directory, so
    no port is taken).  `fn` must be importable by the children (a module
    function).  Returns the ranks' results in rank order; an exception in
    any rank raises here with that rank's traceback.  Every process it
    starts has ended when it returns."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=tmp_dir) as d:
        init_file = os.path.join(d, "rendezvous")
        ctx = mp.spawn(_rank_main, args=(world, init_file, d, threads, fn, args),
                       nprocs=world, join=False)
        try:
            while not ctx.join():
                pass
        except Exception as e:
            errors = []
            for r in range(world):
                path = os.path.join(d, f"rank{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        status, payload = pickle.load(f)
                    if status == "error":
                        errors.append(payload)
            raise RuntimeError("\n".join(errors) or str(e)) from e
        results = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                status, payload = pickle.load(f)
            if status != "ok":
                raise RuntimeError(payload)
            results.append(payload)
        return results


# --------------------------------------------------------------------------
# model meshes
# --------------------------------------------------------------------------

POD_CHIPS = 256
MULTI_POD_CHIPS = 512


@dataclasses.dataclass(eq=False)
class ModelMesh:
    """A model mesh: `shape` maps axis name to size as the reference's
    `Mesh.shape` does, `axis_names` in mesh order, `device` this rank's
    device, `device_mesh` the `DeviceMesh` the DTensors live on (None on a
    1-rank mesh, whose runs are the single-device runs on plain tensors)."""

    shape: dict
    axis_names: tuple
    device: torch.device
    device_mesh: Any = None

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def group(self, axis: str):
        """The process group along `axis` (the ranks that share every other
        coordinate)."""
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis: str) -> int:
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    def submesh(self, axes: tuple) -> "ModelMesh":
        """The mesh over `axes` that holds this rank (a pod's (data, model)
        mesh inside a multi-pod one)."""
        dm = None if self.device_mesh is None else self.device_mesh[tuple(axes)]
        return ModelMesh({a: self.shape[a] for a in axes}, tuple(axes), self.device, dm)


_LIST_GATHER: list = []


def _route_gloo_cuda_gathers() -> None:
    """gloo's `all_gather_into_tensor` kills the process on CUDA tensors
    (SIGSEGV; an H100 with torch 2.11), while its list-form `all_gather`,
    all-reduce and reduce-scatter serve them.  DTensor gathers shards with
    the former, so on gloo ranks on the card the functional op's CUDA
    kernel is replaced, once a process, by one over the list form."""
    if _LIST_GATHER:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather(input, group_size, group_name):
        parts = [torch.empty_like(input) for _ in range(group_size)]
        dist.all_gather(parts, input.contiguous(), group=_resolve_process_group(group_name))
        return torch.cat(parts)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    _LIST_GATHER.append(lib)  # the override lives as long as the library object


def _model_mesh(shape: tuple, axes: tuple, device) -> ModelMesh:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = 1
    for s in shape:
        n *= s
    if n == 1:
        return ModelMesh(dict(zip(axes, shape)), axes, device)
    from torch.distributed.device_mesh import init_device_mesh

    if device.type == "cuda" and dist.get_backend() == "gloo":
        _route_gloo_cuda_gathers()
    dm = init_device_mesh(device.type, shape, mesh_dim_names=axes)
    return ModelMesh(dict(zip(axes, shape)), axes, device, dm)


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_debug_mesh(data: int = 1, model: int = 1, pod: int | None = None, *,
                    device=None) -> ModelMesh:
    """A small model mesh over the ranks of the default process group
    (tests, the card's smoke script): axes ``("data", "model")``, with
    ``"pod"`` in front when `pod` is given.  With fewer ranks than the
    shape needs it falls back to a 1-rank mesh with a logged warning, not
    an error, as the reference's does; a 1-rank mesh (plain tensors) is
    always made, and a wider one that leaves ranks out raises.  `device`
    is this rank's (the card unless the caller asks for the CPU)."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    device = resolve_device(device)
    n, world = 1, _world()
    for s in shape:
        n *= s
    if n > world:
        _log.warning("debug mesh %s needs %d devices but only %d exist — falling back to a "
                     "single-device mesh", dict(zip(axes, shape)), n, world)
        shape = tuple(1 for _ in shape)
    elif 1 < n < world:
        raise ValueError(f"a debug mesh spans every rank (or one): {dict(zip(axes, shape))} "
                         f"covers {n} of {world}")
    return _model_mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> ModelMesh:
    """16 x 16 = 256 ranks ``("data", "model")`` a pod; `multi_pod` stacks
    2 pods = 512 ranks ``("pod", "data", "model")``.  It needs that many
    ranks in the default process group: a cluster, or `fake_world`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = MULTI_POD_CHIPS if multi_pod else POD_CHIPS
    if _world() != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, found {_world()} — run the dry run "
                           "(launch/dryrun.py), which lowers inside fake_world")
    return _model_mesh(shape, axes, resolve_device(device))


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of `world` ranks in this one process (this
    process is rank 0; no collective moves data), for lowering onto the
    production meshes with no cluster.  It refuses to start beside another
    default process group, and destroys its own on exit, so no later mesh
    in the process reads a world of `world`.  Inside it DTensor re-splits a
    sharded dim by one all-to-all, as on the card (`_shard_dim_alltoall`)."""
    if dist.is_initialized():
        raise RuntimeError("fake_world needs the process to have no default process group; "
                           f"one of {dist.get_world_size()} ranks is initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from torch.distributed.tensor import placement_types

    cpu_alltoall = placement_types.shard_dim_alltoall
    dist.init_process_group("fake", world_size=world, rank=0, store=FakeStore())
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = cpu_alltoall
        dist.destroy_process_group()


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's re-split of a sharded dim, as the card's ranks run it: one
    all-to-all (`_dtensor::shard_dim_alltoall`, which the fake group
    serves), where on CPU ranks DTensor would gather the whole tensor and
    keep a chunk (gloo has no all-to-all).  The dry run's meshes are CPU
    meshes in a fake world, so this is its route."""
    import torch.distributed._functional_collectives as funcol

    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 funcol._group_or_group_name(group))
