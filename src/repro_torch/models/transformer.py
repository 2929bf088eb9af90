"""Decoder-only transformer LM, dense attention blocks (port of the training
path of `repro/models/transformer.py`).

Layout, as the reference's: the arch's `block_pattern` is stacked
`num_layers // len(pattern)` times into "superblocks" whose params carry a
leading layer axis (`params["super"][pos]["attn"]["wq"]` is (L, d, H*hd)),
and the remainder layers are an unstacked "tail" list.  The leaves, their
order and their shapes are the reference's, so a message's per-leaf QSGD
keys and its ledger price are too.  `forward` loops over the layer axis
where the reference scans it.

`forward(..., remat=True)` recomputes each superblock in the backward pass
instead of keeping its activations, as the reference's `jax.checkpoint`
of the scanned superblock does: `RematBlock` keeps only the block's input
and layer tensors, and its backward runs the block again under
`torch.func.vjp`.  (`torch.utils.checkpoint` cannot run under the
engine's `vmap(grad_and_value(...))`: torch.func refuses its saved-tensor
hooks, and its reentrant form has no `setup_context`.)

Block kinds ported: "attn" and "local" (sliding window), with a dense FFN.
Not ported (`check_ported` raises NotImplementedError): MLA, MoE, SSD and
RG-LRU blocks, the encoder, patch embeddings, multi-token prediction;
decode, prefill and serving.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.func import vjp

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attention_forward, init_attention
from repro_torch.models.common import cross_entropy_loss, dense_init, rms_norm
from repro_torch.models.ffn import ffn_forward, init_ffn
from repro_torch.utils import tree_flatten, tree_unflatten

KINDS = ("attn", "local")


def check_ported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for the parts of `cfg` the port lacks."""
    missing = [name for name, on in (
        ("MLA", cfg.mla is not None), ("MoE", cfg.is_moe),
        ("encoder", cfg.is_encoder_decoder), ("patch embeddings", bool(cfg.num_patches)),
        ("multi-token prediction", bool(cfg.mtp_depth)),
    ) if on]
    missing += [f"{kind!r} blocks" for kind in dict.fromkeys(cfg.block_pattern)
                if kind not in KINDS]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported to repro_torch yet: {missing}")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layout(cfg: ArchConfig) -> tuple[int, int]:
    """(n_super, n_tail): num_layers = n_super * len(pattern) + n_tail."""
    plen = len(cfg.block_pattern)
    return cfg.num_layers // plen, cfg.num_layers % plen


def init_block(cfg: ArchConfig, gen: torch.Generator, dtype, lead: tuple = ()) -> dict:
    ones = torch.ones((*lead, cfg.d_model), dtype=dtype, device=gen.device)
    return {"ln1": ones, "attn": init_attention(cfg, gen, dtype, lead),
            "ln2": ones.clone(), "ffn": init_ffn(cfg, gen, dtype, lead)}


def block_forward(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,T,d) -> x'. Causal training path."""
    window = cfg.sliding_window if kind == "local" else None
    x = x + attention_forward(cfg, p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                              window=window)
    return x + ffn_forward(cfg, p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps))


def init_params(cfg: ArchConfig, seed: int, device) -> dict:
    """Random params from `seed`, drawn with a generator on `device`."""
    check_ported(cfg)
    dtype = _dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_super, n_tail = _layout(cfg)
    p: dict = {
        "embed": dense_init(gen, cfg.vocab_size, cfg.d_model, scale=0.02, dtype=dtype),
        "super": [init_block(cfg, gen, dtype, (n_super,)) for _ in cfg.block_pattern]
        if n_super else [],
        "tail": [init_block(cfg, gen, dtype) for _ in range(n_tail)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=dtype)
    return p


def super_block(cfg: ArchConfig, treedefs: tuple, h: torch.Tensor, *leaves) -> torch.Tensor:
    """One superblock: the layers of `cfg.block_pattern` in turn.  `leaves`
    are the layers' tensors in pattern order, `treedefs` their structures."""
    i = 0
    for kind, (treedef, n) in zip(cfg.block_pattern, treedefs):
        h = block_forward(cfg, kind, tree_unflatten(treedef, list(leaves[i:i + n])), h)
        i += n
    return h


class RematBlock(torch.autograd.Function):
    """A superblock that keeps no activations: the forward saves its input
    and layer tensors only, and the backward recomputes the block under
    `torch.func.vjp` and pulls the cotangent back through it.  The vmap rule
    is generated, so it runs under the engine's vmap over clients; a flash
    attention call inside it runs its kernel again in the recompute."""

    generate_vmap_rule = True

    @staticmethod
    def forward(cfg, treedefs, h, *leaves):
        return super_block(cfg, treedefs, h, *leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        cfg, treedefs, h, *leaves = inputs
        ctx.cfg, ctx.treedefs = cfg, treedefs
        ctx.save_for_backward(h, *leaves)

    @staticmethod
    def backward(ctx, ct):
        _, pullback = vjp(lambda *xs: super_block(ctx.cfg, ctx.treedefs, *xs),
                          *ctx.saved_tensors)
        return (None, None, *pullback(ct))


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False) -> torch.Tensor:
    """-> logits (B, T, V).  `remat` recomputes each superblock in the
    backward pass (`RematBlock`)."""
    x = F.embedding(batch["tokens"].long(), params["embed"])
    plen = len(cfg.block_pattern)
    n_super, n_tail = _layout(cfg)
    # one unbind per stacked leaf: its backward stacks the layers' grads
    # once, where indexing each layer fills and adds a zero tensor of the
    # whole stack per layer
    stacks = []
    for pos in range(plen if n_super else 0):
        leaves, treedef = tree_flatten(params["super"][pos])
        stacks.append((treedef, [leaf.unbind(0) for leaf in leaves]))
    treedefs = tuple((treedef, len(layers)) for treedef, layers in stacks)
    for r in range(n_super):
        leaves = [u[r] for _, layers in stacks for u in layers]
        if remat:
            x = RematBlock.apply(cfg, treedefs, x, *leaves)
        else:
            x = super_block(cfg, treedefs, x, *leaves)
    for i in range(n_tail):
        x = block_forward(cfg, cfg.block_kind(n_super * plen + i), params["tail"][i], x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False) -> torch.Tensor:
    return cross_entropy_loss(forward(cfg, params, batch, remat=remat), batch["labels"])
