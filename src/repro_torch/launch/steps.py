"""Step builders and their lowering for a mesh (port of
`repro/launch/steps.py`).

Three step kinds per architecture:

* ``train`` (`make_train_round`): one Fed-CHS round over C chains (one
  active-model copy per cluster), each chain's params stacked on a leading
  axis: every chain takes one SGD step on its cluster's batch, then the
  sequential ES -> ES pass rolls the chains by one (`variant="fedchs"`), or
  the star-shaped chain mean replaces it (`variant="hfl"`, the
  conventional HFL baseline).  On one device the chains are vmapped.  On a
  model mesh the params are DTensors (`sharding.specs.distribute`); with a
  ``"pod"`` axis chain c lives on pod c, so each rank computes its own
  pod's chain on the pod's (data, model) mesh, no vmap: Eq. (5)'s
  within-cluster aggregation is the gradient sum over ``"data"``, the pass
  is a pod-axis permutation (the reference's roll, which XLA lowers to a
  collective-permute) and the HFL mean an all-reduce over ``"pod"``.
* ``prefill`` (`make_prefill_step`): the forward over a whole prompt,
  next-token logits.
* ``decode`` (`make_decode_step`): one new token against the caches.

The lowering: `build_lowering(cfg, shape, mesh)` gives a `LoweringSpec`
(the step, its abstract arguments as meta tensors, their shardings), and
`lower_spec(spec, mesh)` runs the step once on fake tensors laid out on the
mesh (`FakeTensorMode`; on the production meshes inside `mesh.fake_world`)
under the roofline's counting mode, and returns the counted `Trace`
(`roofline.analyze_trace` reads it).  Where XLA compiles one program, the
port runs its eager ops on each device's share.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.func import vmap

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.sharding.ctx import current_mesh, model_mesh
from repro_torch.sharding.specs import (PartitionSpec as P, batch_pspec, cache_pspecs,
                                        distribute, named_shardings, param_pspecs)
from repro_torch.utils import (grad_and_value, tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)

PyTree = Any  # the reference's name for a tree of tensors

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, mode="decode"),
}


def num_chains(mesh) -> int:
    return mesh.shape["pod"] if "pod" in mesh.axis_names else 1


def _vocab_axis(cfg: ArchConfig, mesh):
    n_model = mesh.shape["model"] if "model" in mesh.axis_names else 1
    return "model" if n_model > 1 and cfg.vocab_size % n_model == 0 else None


def _is_dtensor(x) -> bool:
    return hasattr(x, "device_mesh") and hasattr(x, "placements")


@contextlib.contextmanager
def _replicating():
    """DTensor ops take the plain tensors a step makes (positions, masks,
    zeros) as replicated.  Re-entrant: DTensor's own
    `implicit_replication` turns the switch off on leaving, an enclosing
    block's too."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


# --------------------------------------------------------------------------
# abstract inputs: meta tensors (shapes and dtypes, no data)
# --------------------------------------------------------------------------


def _meta(tree, lead: tuple = ()):
    return tree_map(lambda t: torch.empty((*lead, *t.shape), dtype=t.dtype, device="meta"), tree)


def _token_batch_struct(cfg: ArchConfig, batch: int, seq: int, *, chain: int | None,
                        dtype) -> dict:
    lead = (chain,) if chain else ()
    toks = torch.empty((*lead, batch, seq), dtype=torch.int32, device="meta")
    out = {"tokens": toks, "labels": toks}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.empty((*lead, batch, cfg.num_audio_frames, cfg.d_model),
                                    dtype=dtype, device="meta")
    if cfg.num_patches:
        out["patches"] = torch.empty((*lead, batch, cfg.num_patches, tf.PATCH_DIM),
                                     dtype=dtype, device="meta")
    return out


def abstract_params(cfg: ArchConfig, *, chains: int = 0):
    """The params' shapes and dtypes as meta tensors (with `chains`, a
    leading chain axis): `init_params` runs under `FakeTensorMode`, which
    allocates nothing and draws nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        p = tf.init_params(cfg, 0, "cpu")
    return _meta(p, (chains,) if chains else ())


def abstract_caches(cfg: ArchConfig, batch: int, capacity: int):
    from torch._subclasses.fake_tensor import FakeTensorMode

    enc_len = cfg.num_audio_frames if cfg.is_encoder_decoder else 0
    with FakeTensorMode():
        c = tf.init_caches(cfg, batch, capacity, enc_len=enc_len, device="cpu")
    return _meta(c)


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------


def _from_local(local: torch.Tensor, mesh, placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh.device_mesh, placements, run_check=False)


def _shift(placements, by: int) -> tuple:
    """Shard dims moved by `by` (a chain axis dropped or put back)."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(p.dim + by) if p.is_shard() else p for p in placements)


def _mesh_grad(fn, params, batch):
    """(grads, loss) of `fn(params, batch)` on DTensors, by plain autograd:
    under `torch.func` the DTensors would be wrapped and lose the layouts
    the model reads from them."""
    from torch.distributed.tensor import Replicate

    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss = fn(tree_unflatten(treedef, leaves), batch)
    loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
    grads = torch.autograd.grad(loss, leaves)
    return tree_unflatten(treedef, list(grads)), loss.detach()


def _pod_gather(local: torch.Tensor, mesh) -> list:
    """Every pod's `local`, in pod order (the list form of all_gather, which
    gloo serves on CUDA tensors)."""
    parts = [torch.empty_like(local) for _ in range(mesh.shape["pod"])]
    dist.all_gather(parts, local.contiguous(), group=mesh.group("pod"))
    return parts


def _pod_round(cfg: ArchConfig, mesh, chain_loss, variant: str, stacked, batch, lr: float):
    """One round on a multi-pod mesh: this rank's pod trains its own chain
    on the pod's (data, model) mesh, then the pass (or the mean) over pods."""
    from repro_torch.roofline.analysis import billed_as

    sub = mesh.submesh(("data", "model"))
    C, c = mesh.shape["pod"], mesh.axis_index("pod")
    p_leaves, p_def = tree_flatten(stacked)
    b_leaves, b_def = tree_flatten(batch)

    def own(t):  # chain c's leaf on the pod's mesh
        return _from_local(t.to_local()[0], sub, _shift(t.placements[1:], -1))

    params = tree_unflatten(p_def, [own(t) for t in p_leaves])
    with model_mesh(sub):
        grads, loss = _mesh_grad(chain_loss, params, tree_unflatten(b_def, [
            own(t) for t in b_leaves]))
        new = tf.sgd_update(params, grads, lr)
    out = []
    for t, n in zip(p_leaves, tree_leaves(new)):
        local = n.redistribute(sub.device_mesh, _shift(t.placements[1:], -1)).to_local()[None]
        if variant == "fedchs":
            # sequential ES -> ES pass: chain c moves to pod (c + 1) % C
            with billed_as("collective-permute", local.numel() * local.element_size()):
                local = _pod_gather(local, mesh)[(c - 1) % C]
        else:
            # star aggregation at the PS: the chain mean, on every pod
            local = _pod_mean(local, mesh)
        out.append(_from_local(local, mesh, t.placements))
    loss = loss.full_tensor() if _is_dtensor(loss) else loss
    return tree_unflatten(p_def, out), _pod_mean(loss, mesh)


def _pod_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_reduce(t.contiguous(), "sum", mesh.group("pod"))
    out = out.wait() if hasattr(out, "wait") else out
    return (out / mesh.shape["pod"]).to(t.dtype)


def make_train_round(cfg: ArchConfig, *, variant: str = "fedchs", remat: bool = True,
                     remat_policy: str | None = None, spmd_axis: str | None = None):
    """(stacked_params (C, ...), batch {tokens (C, B, T), ...}, lr) ->
    (new stacked params, mean loss over the chains).

    On DTensor params the round runs on the model mesh published in
    `sharding.ctx` (`lower_spec` publishes it; so do the card's runs).
    `spmd_axis` is the reference's vmap `spmd_axis_name`: on a mesh with
    ``"pod"`` the port keeps each chain on its pod and vmaps nothing, so
    the MoE interior's sums stay within the chain's pod whatever it says."""
    if variant not in ("fedchs", "hfl"):
        raise ValueError(variant)
    del spmd_axis

    def chain_loss(params, batch):
        return tf.loss_fn(cfg, params, batch, remat=remat, remat_policy=remat_policy)

    def round_fn(stacked_params, batch, lr: float):
        leaf = tree_leaves(stacked_params)[0]
        C = leaf.shape[0]
        on_mesh = _is_dtensor(leaf)
        with _replicating() if on_mesh else contextlib.nullcontext():
            mesh = current_mesh() if on_mesh else None
            if mesh is not None and "pod" in mesh.axis_names and C > 1:
                return _pod_round(cfg, mesh, chain_loss, variant, stacked_params, batch, lr)
            if C == 1:
                # one chain: no vmap; the pass and the star mean are identities
                chain = (tree_map(lambda x: x[0], stacked_params), tree_map(lambda x: x[0], batch))
                grads, loss = (_mesh_grad(chain_loss, *chain) if on_mesh
                               else grad_and_value(chain_loss)(*chain))
                return (tf.sgd_update(stacked_params, tree_map(lambda g: g[None], grads), lr),
                        loss)
            if on_mesh:
                raise ValueError("chains on a model mesh live on its 'pod' axis")
        grads, losses = vmap(grad_and_value(chain_loss))(stacked_params, batch)
        new = tf.sgd_update(stacked_params, grads, lr)
        if variant == "fedchs":
            # sequential ES -> ES pass: chain c moves to cluster (c + 1) % C
            passed = tree_map(lambda x: torch.roll(x, 1, dims=0), new)
        else:
            # star aggregation at the PS: the chain mean, broadcast back
            passed = tree_map(lambda x: x.mean(dim=0, keepdim=True).expand_as(x).clone(), new)
        return passed, losses.mean()

    return round_fn


def make_prefill_step(cfg: ArchConfig, *, last_only: bool = False):
    """(params, batch) -> next-token logits (B, V).  `last_only` slices the
    hidden state before the LM head instead of computing (B, T, V) logits
    and slicing after."""

    def prefill_fn(params, batch):
        logits, _ = tf.forward(cfg, params, batch, last_only=last_only)
        return logits[:, -1]

    return prefill_fn


def make_decode_step(cfg: ArchConfig):
    """(params, caches, token (B, 1)) -> (logits (B, V), new caches)."""

    def decode_fn(params, caches, token):
        return tf.decode_step(cfg, params, caches, token)

    return decode_fn


# --------------------------------------------------------------------------
# dry-run assembly: (fn, abstract args, shardings)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LoweringSpec:
    name: str
    fn: Any
    args: tuple          # meta tensors (and the lr)
    in_shardings: tuple  # NamedSharding trees, one per tensor argument (None: a scalar)
    out_shardings: Any
    donate_argnums: tuple = ()  # production buffers (params / caches) are donated


def apply_optimizations(cfg: ArchConfig, mesh) -> ArchConfig:
    """The beyond-paper performance config: group-limited MoE routing
    aligned to the data shards, and the MoE interior with its collectives
    written out (`models/moe_shardmap.py`)."""
    updates: dict = {}
    if cfg.is_moe and "data" in mesh.axis_names:
        updates["moe_groups"] = int(mesh.shape["data"])
        updates["moe_shardmap"] = True
    return dataclasses.replace(cfg, **updates) if updates else cfg


DP_PARAM_THRESHOLD = 1_000_000_000


def _use_pure_dp(cfg: ArchConfig, per_chain_batch: int, mesh) -> bool:
    """Sub-1B models are over-sharded by 16-way TP (tiny matmul shards and
    per-layer activation all-reduces dominate): replicate the params and
    split the batch over (data, model) instead."""
    chips = 1
    for a in ("data", "model"):
        if a in mesh.axis_names:
            chips *= mesh.shape[a]
    return cfg.param_count() < DP_PARAM_THRESHOLD and per_chain_batch % chips == 0


def _map_specs(fn, specs):
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return type(specs)(_map_specs(fn, v) for v in specs)


def build_lowering(cfg: ArchConfig, shape_name: str, mesh, *, variant: str = "fedchs",
                   optimized: bool = False) -> LoweringSpec:
    if optimized:
        cfg = apply_optimizations(cfg, mesh)
    info = SHAPES[shape_name]
    seq, gbatch, mode = info["seq_len"], info["global_batch"], info["mode"]
    dtype = getattr(torch, cfg.dtype)

    if mode == "train":
        C = num_chains(mesh)
        assert gbatch % C == 0
        params = abstract_params(cfg, chains=C)
        per_chain = gbatch // C
        pure_dp = optimized and _use_pure_dp(cfg, per_chain, mesh)
        p_sh = param_shardings(cfg, mesh, chains=C, pure_dp=pure_dp)
        chain_axis = "pod" if C > 1 else None
        batch = _token_batch_struct(cfg, per_chain, seq, chain=C, dtype=dtype)
        if pure_dp:
            data_axis = ("data", "model")
        else:
            data_axis = "data" if per_chain % mesh.shape["data"] == 0 else None
        bspec = {k: P(chain_axis, data_axis, *([None] * (v.ndim - 2))) for k, v in batch.items()}
        remat_policy = tf.DOTS_SAVEABLE if optimized else None
        spmd_axis = ("pod" if (optimized and cfg.moe_shardmap and C > 1
                               and "pod" in mesh.axis_names) else None)
        fn = make_train_round(cfg, variant=variant, remat_policy=remat_policy,
                              spmd_axis=spmd_axis)
        args = (params, batch, 0.1)
        in_sh = (p_sh, named_shardings(mesh, bspec), None)
        out_sh = (p_sh, None)
        return LoweringSpec(f"{cfg.name}:{shape_name}:{variant}", fn, args, in_sh, out_sh,
                            donate_argnums=(0,))

    params = abstract_params(cfg)
    pspecs = param_pspecs(params, num_experts=cfg.num_experts, mesh=mesh,
                          expert_axis=cfg.expert_axis)
    baxes = batch_pspec(gbatch, mesh, rank=1)[0]
    logits_sh = named_shardings(mesh, P(baxes, _vocab_axis(cfg, mesh)))

    if mode == "prefill":
        batch = _token_batch_struct(cfg, gbatch, seq, chain=None, dtype=dtype)
        bspec = {k: P(baxes, *([None] * (v.ndim - 1))) for k, v in batch.items()}
        fn = make_prefill_step(cfg)
        in_sh = (named_shardings(mesh, pspecs), named_shardings(mesh, bspec))
        return LoweringSpec(f"{cfg.name}:{shape_name}", fn, (params, batch), in_sh, logits_sh)

    # decode
    caches = abstract_caches(cfg, gbatch, seq)
    cspecs = cache_pspecs(caches, gbatch, mesh)
    token = torch.empty((gbatch, 1), dtype=torch.int32, device="meta")
    fn = make_decode_step(cfg)
    in_sh = (named_shardings(mesh, pspecs), named_shardings(mesh, cspecs),
             named_shardings(mesh, P(baxes, None)))
    out_sh = (logits_sh, named_shardings(mesh, cspecs))
    return LoweringSpec(f"{cfg.name}:{shape_name}", fn, (params, caches, token), in_sh,
                        out_sh, donate_argnums=(1,))


def param_shardings(cfg: ArchConfig, mesh, *, chains: int = 0, pure_dp: bool = False):
    """NamedShardings of the params on `mesh` (`param_pspecs`; with
    `chains` a leading chain axis on "pod" when there are several, and with
    `pure_dp` every param whole on every rank)."""
    pspecs = param_pspecs(abstract_params(cfg), num_experts=cfg.num_experts, mesh=mesh,
                          expert_axis=cfg.expert_axis)
    if pure_dp:
        pspecs = _map_specs(lambda s: P(*([None] * len(s))), pspecs)
    if chains:
        pspecs = _map_specs(lambda s: P("pod" if chains > 1 else None, *s), pspecs)
    return named_shardings(mesh, pspecs)


def place(cfg: ArchConfig, mesh, params=None, batch=None, caches=None, *, chains: int = 0):
    """The card's and the tests' model-mesh inputs: whole tensors (the same
    on every rank) laid out as the dry run lays them: params by
    `param_shardings` (stacked on a chain axis when `chains`), a batch
    {tokens (C?, B, T), ...} split on its batch axis (with `chains`, the
    chain axis on "pod", the batch on "data"; else on `batch_pspec`'s
    axes), caches by `cache_pspecs`.  Returns the laid-out trees given, in
    that order."""
    out = []
    if params is not None:
        out.append(distribute(params, param_shardings(cfg, mesh, chains=chains)))
    if batch is not None:
        if chains:
            bs = {k: P("pod" if chains > 1 else None, "data") for k in batch}
        else:
            b = tree_leaves(batch)[0].shape[0]
            bs = {k: P(batch_pspec(b, mesh, rank=1)[0]) for k in batch}
        out.append(distribute(batch, named_shardings(mesh, bs)))
    if caches is not None:
        b = tree_leaves(caches["super"] or caches["tail"])[0]
        bsz = b.shape[1] if caches["super"] else b.shape[0]
        out.append(distribute(caches, named_shardings(mesh, cache_pspecs(caches, bsz, mesh))))
    return out[0] if len(out) == 1 else tuple(out)


def _laid_out(tree, shardings):
    """Fake tensors of the meta tree's shapes, laid out by `shardings` (the
    chain and batch trees' NamedShardings; None leaves a scalar as it is)."""
    if shardings is None:
        return tree
    fakes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="cpu"), tree)
    return distribute(fakes, shardings)


def _redistributed(tree, shardings):
    """The step's outputs moved to their out shardings, as XLA's
    out_shardings move them."""
    if shardings is None or not any(_is_dtensor(t) for t in tree_leaves(tree)):
        return tree
    if not isinstance(tree, (dict, list, tuple)):
        return tree.redistribute(tree.device_mesh, shardings.placements)
    if isinstance(tree, dict):
        return {k: _redistributed(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(_redistributed(v, s) for v, s in zip(tree, shardings))


def lower_spec(spec: LoweringSpec, mesh):
    """Run the step once on fake tensors laid out on `mesh`, counted: the
    port's lowering.  Returns the `roofline.analysis.Trace` of one device
    (rank 0's share; every rank of an SPMD step runs the same shapes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline.analysis import counting

    with FakeTensorMode(), model_mesh(mesh):
        args = tuple(_laid_out(a, sh) for a, sh in zip(spec.args, spec.in_shardings))
        with _replicating() if mesh.device_mesh is not None else contextlib.nullcontext():
            with counting(args) as trace:
                out = _redistributed(spec.fn(*args), spec.out_shardings)
        trace.add_outputs(out)
    return trace
