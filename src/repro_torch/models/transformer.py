"""The transformer LM of every configured family: attention, SSD and RG-LRU
blocks with a dense or MoE FFN, an encoder with cross-attention, patch
embeddings, training and serving (port of `repro/models/transformer.py`).

Layout, as the reference's: the arch's `block_pattern` is stacked
`num_layers // len(pattern)` times into "superblocks" whose params carry a
leading layer axis (`params["super"][pos]["attn"]["wq"]` is (L, d, H*hd)),
and the remainder layers are an unstacked "tail" list.  The leaves, their
order and their shapes are the reference's, so a message's per-leaf QSGD
keys and its ledger price are too.  `forward` loops over the layer axis
where the reference scans it.  Decode caches are laid out the same way:
`init_caches(...)["super"][pos]` stacks the layers' caches on a leading
axis (batch on axis 1), `["tail"][i]` holds one layer's (batch on axis 0).

Entry points (all functional):
  init_params(cfg, seed, device)          -> params
  forward(cfg, params, batch)             -> (logits, aux_loss)
  loss_fn(cfg, params, batch)             -> cross entropy + aux_loss
  make_train_step(cfg)                    -> (params, batch, lr) -> (params, loss)
  init_caches(cfg, batch, capacity)       -> caches
  decode_step(cfg, params, caches, token) -> (logits (B, V), caches)
  prefill(cfg, params, batch)             -> (last-position logits, caches)

`forward(..., remat=True)` recomputes each superblock in the backward pass
instead of keeping its activations, as the reference's `jax.checkpoint`
of the scanned superblock does: `RematBlock` keeps only the block's
inputs (the activations, the encoder's output when there is one, and the
layer tensors), and its backward runs the block again under
`torch.func.vjp`.  (`torch.utils.checkpoint` cannot run under the
engine's `vmap(grad_and_value(...))`: torch.func refuses its saved-tensor
hooks, and its reentrant form has no `setup_context`.)  The saving holds
under the port's `utils.grad_and_value`, whose backward builds no graph;
under `torch.func.grad_and_value` the backward's own graph keeps every
block's recompute alive until the last gradient is made.  With
`remat_policy=DOTS_SAVEABLE` (the reference's
`jax.checkpoint_policies.dots_with_no_batch_dims_saveable`, the dry run's
`--opt`) the block also keeps the outputs of its products with 2-D weights
(`aten.mm`; attention's and the experts' batched products are `bmm`) and
the recompute takes them instead of running them again: the gradients are
bit for bit those of `remat=True` without a policy.

Block kinds (`KINDS`): "attn" and "local" (sliding window; MLA when
`cfg.mla` is set), "ssd" (Mamba-2, no FFN) and "rglru" (Griffin), each but
"ssd" with a dense or MoE FFN; another kind raises ValueError in
`init_block`.  Whisper adds an encoder over stub frame embeddings
(`batch["frames"]`) and cross-attention in every decoder block, with the
encoder's K/V pinned in the decode caches; Phi-3-vision prepends projected
stub patch embeddings (`batch["patches"]`, width 1024) to the tokens;
DeepSeek adds a multi-token prediction head (`cfg.mtp_depth`, `_mtp_loss`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from torch.func import vjp
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models import rglru, ssd
from repro_torch.models.common import (cross_entropy_loss, dense_init, layout_grad, rms_norm,
                                      split_keys)
from repro_torch.models.ffn import ffn_forward, init_ffn, init_moe, moe_forward
from repro_torch.utils import (grad_and_value, resolve_device, tree_flatten, tree_leaves,
                               tree_map, tree_unflatten)

PyTree = Any  # the reference's name for a tree of tensors
KINDS = ("attn", "local", "ssd", "rglru")
DOTS_SAVEABLE = "dots_with_no_batch_dims_saveable"  # the one remat policy
PATCH_DIM = 1024  # width of the stub patch embeddings the projector maps to d_model


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layout(cfg: ArchConfig) -> tuple[int, int]:
    """(n_super, n_tail): num_layers = n_super * len(pattern) + n_tail."""
    plen = len(cfg.block_pattern)
    return cfg.num_layers // plen, cfg.num_layers % plen


def _head(cfg: ArchConfig, params: dict) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if hasattr(head, "device_mesh"):
        # vocab-split logits on a model mesh (a tied embedding is split on
        # d_model): the head's bytes move, never the (B, T, V) logits'
        from torch.distributed.tensor import Shard

        names, n = head.device_mesh.mesh_dim_names, head.device_mesh.shape
        pl = list(head.placements)
        for i, name in enumerate(names):
            if name == "model" and pl[i].is_shard(0) and head.shape[1] % n[i] == 0:
                pl[i] = Shard(1)
                head = head.redistribute(head.device_mesh, pl)
    return head


# ==========================================================================
# per-block init / forward / decode
# ==========================================================================


def _has_ffn(kind: str) -> bool:
    return kind != "ssd"  # mamba2 blocks are mixer-only


def init_block(cfg: ArchConfig, kind: str, key: np.ndarray, dtype, device) -> dict:
    """A block's params under key words `key` (*lead, 2), as the reference
    draws them (`split(key, 3)`: the mixer, the FFN, an encoder-decoder's
    cross-attention); `lead` = (layers,) stacks that many blocks."""
    k1, k2, k3 = split_keys(key, 3)
    ones = torch.ones((*k1.shape[:-1], cfg.d_model), dtype=dtype, device=device)
    p: dict = {"ln1": ones}
    if kind == "ssd":
        p["mixer"] = ssd.init_ssd_block(cfg, k1, dtype, device)
    elif kind == "rglru":
        p["mixer"] = rglru.init_rglru_block(cfg, k1, dtype, device)
    elif kind in ("attn", "local"):
        init = attn.init_mla if cfg.mla is not None else attn.init_attention
        p["attn"] = init(cfg, k1, dtype, device)
        if cfg.is_encoder_decoder:
            p["ln_x"] = ones.clone()
            xcfg = dataclasses.replace(cfg, qkv_bias=False, qk_norm=False)
            p["xattn"] = attn.init_attention(xcfg, k3, dtype, device)
    else:
        raise ValueError(kind)
    if _has_ffn(kind):
        p["ln2"] = ones.clone()
        p["ffn"] = (init_moe if cfg.is_moe else init_ffn)(cfg, k2, dtype, device)
    return p


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """On a model mesh, a block's output `y` laid out as the residual
    stream `x` (batch split, whole over "model"): the sum of a
    row-parallel product's partial outputs, as Megatron's layout and the
    reference's GSPMD one do.  Plain tensors pass through."""
    if hasattr(y, "device_mesh") and tuple(y.placements) != tuple(x.placements):
        return y.redistribute(y.device_mesh, x.placements)
    return y


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """rms_norm at the entrance of a sub-layer (or the head) of a training
    forward: on a model mesh its gradient comes back whole over "model"
    (`common.layout_grad`), so no product of the backward repeats on
    every rank."""
    return layout_grad(rms_norm(x, w, eps))


def _stream(x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """On a model mesh, the embedded stream split as the tokens' batch is
    and whole along every other mesh axis."""
    if not hasattr(x, "device_mesh"):
        return x
    from torch.distributed.tensor import Replicate, Shard

    pl = [Shard(0) if p.is_shard(0) else Replicate() for p in tokens.placements]
    return x.redistribute(x.device_mesh, pl)


def _ffn(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor, moe_method: str):
    """x + FFN(norm(x)), and the block's aux loss (f32 zero without MoE);
    x itself for a block without an FFN."""
    if _has_ffn(kind):
        h = _norm(x, p["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            y, aux = moe_forward(cfg, p["ffn"], h, method=moe_method)
            return x + _like(y, x), aux
        x = x + _like(ffn_forward(cfg, p["ffn"], h), x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def block_forward(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor, *,
                  enc_out: torch.Tensor | None = None,
                  moe_method: str = "expert_choice") -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,d) -> (x', aux). Causal training / prefill path; an
    encoder-decoder's attention blocks then attend to `enc_out` (B,F,d)."""
    h = _norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssd":
        x = x + _like(ssd.ssd_block_forward(cfg, p["mixer"], h), x)
    elif kind == "rglru":
        x = x + _like(rglru.rglru_block_forward(cfg, p["mixer"], h), x)
    else:
        if cfg.mla is not None:
            y = attn.mla_forward(cfg, p["attn"], h)
        else:
            window = cfg.sliding_window if kind == "local" else None
            y = attn.attention_forward(cfg, p["attn"], h, window=window)
        x = x + _like(y, x)
        if cfg.is_encoder_decoder and enc_out is not None:
            hx = _norm(x, p["ln_x"], cfg.norm_eps)
            x = x + _like(_cross_attention(cfg, p["xattn"], hx, enc_out), x)
    return _ffn(cfg, kind, p, x, moe_method)


def _cross_attention(cfg: ArchConfig, p: dict, x: torch.Tensor, enc_out: torch.Tensor
                     ) -> torch.Tensor:
    """Decoder -> encoder attention: no RoPE, every frame visible, the
    blockwise path (the reference's, never the flash kernel)."""
    B, T, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    F_enc = enc_out.shape[1]
    q = attn.split_heads(x @ p["wq"], B, T, h, hd)
    k = attn.split_heads(enc_out @ p["wk"], B, F_enc, hkv, hd)
    v = attn.split_heads(enc_out @ p["wv"], B, F_enc, hkv, hd)
    out = attn.local_heads(lambda q, k, v: attn.blockwise_attention(q, k, v, causal=False),
                           q, k, v)
    return layout_grad(out.reshape(B, T, -1)) @ p["wo"]


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, capacity: int, dtype,
                     device, enc_len: int = 0) -> dict:
    """A block's decode cache; a sliding-window block's is a ring buffer of
    at most `sliding_window` entries, an SSD or RG-LRU block's holds its
    conv histories and state, and an encoder-decoder's attention block
    also the encoder's K/V over `enc_len` frames (zeros until
    `_fill_cross_caches`)."""
    if kind == "ssd":
        return {"mixer": ssd.init_ssd_cache(cfg, batch, dtype, device)}
    if kind == "rglru":
        return {"mixer": rglru.init_rglru_cache(cfg, batch, dtype, device)}
    cap = capacity if kind == "attn" else min(capacity, cfg.sliding_window)
    init = attn.init_mla_cache if cfg.mla is not None else attn.init_attn_cache
    c = {"self": init(cfg, batch, cap, dtype, device)}
    if cfg.is_encoder_decoder:
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def block_decode(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor, cache: dict, *,
                 moe_method: str = "expert_choice") -> tuple[torch.Tensor, dict]:
    """x (B,1,d) against the block's cache -> (x', new cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ("ssd", "rglru"):
        mixer = ssd.ssd_block_decode if kind == "ssd" else rglru.rglru_block_decode
        y, new = mixer(cfg, p["mixer"], h, cache["mixer"])
        x, cache = x + y, dict(cache, mixer=new)
    else:
        if cfg.mla is not None:
            y, new = attn.mla_decode(cfg, p["attn"], h, cache["self"])
        else:
            window = cfg.sliding_window if kind == "local" else None
            y, new = attn.attention_decode(cfg, p["attn"], h, cache["self"], window=window)
        x, cache = x + y, dict(cache, self=new)
        if cfg.is_encoder_decoder:
            # the pinned encoder K/V, every frame visible
            hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
            B, F_enc = x.shape[0], cache["cross_k"].shape[1]
            q = attn.split_heads(hx @ p["xattn"]["wq"], B, 1, cfg.num_heads, cfg.head_dim)
            out = attn.local_heads(attn.decode_attention, q, cache["cross_k"], cache["cross_v"],
                                   batch=(torch.full((B,), F_enc, dtype=torch.int32,
                                                     device=x.device),), repeat_kv=False)
            x = x + out.reshape(B, 1, -1) @ p["xattn"]["wo"]
    x, _ = _ffn(cfg, kind, p, x, moe_method)
    return x, cache


# ==========================================================================
# params, forward, loss, train step
# ==========================================================================


def init_params(cfg: ArchConfig, seed: int, device) -> dict:
    """The reference's `init_params(cfg, PRNGKey(seed))`, bit for bit: its
    key tree walked on the host (`core/prng.py`), every random leaf drawn by
    `kernels/normal.py` on `device` (the CUDA kernel on the card, its plain
    version on the CPU)."""
    dtype = _dtype(cfg)
    n_super, n_tail = _layout(cfg)
    plen = len(cfg.block_pattern)
    keys = prng.split(prng.PRNGKey(seed), cfg.num_layers + cfg.encoder_layers + 8)
    p: dict = {
        "embed": dense_init(keys[-1], cfg.vocab_size, cfg.d_model, scale=0.02, dtype=dtype,
                            device=device),
        # pattern position pos of repetition r takes keys[r * plen + pos]
        "super": [init_block(cfg, kind, keys[pos:n_super * plen:plen], dtype, device)
                  for pos, kind in enumerate(cfg.block_pattern)] if n_super else [],
        "tail": [init_block(cfg, cfg.block_kind(n_super * plen + i), keys[n_super * plen + i],
                            dtype, device) for i in range(n_tail)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(keys[-2], cfg.d_model, cfg.vocab_size, dtype=dtype,
                                  device=device)
    if cfg.is_encoder_decoder:
        p["encoder"] = {
            "blocks": _init_encoder_block(_encoder_cfg(cfg),
                                          prng.split(keys[-3], cfg.encoder_layers), dtype,
                                          device),
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        }
    if cfg.num_patches:
        p["projector"] = dense_init(keys[-4], PATCH_DIM, cfg.d_model, dtype=dtype,
                                    device=device)
    if cfg.mtp_depth:
        p["mtp"] = {
            "proj": dense_init(keys[-5], 2 * cfg.d_model, cfg.d_model, dtype=dtype,
                               device=device),
            "block": init_block(cfg, "attn", keys[-6], dtype, device),
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        }
    return p


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The encoder's blocks: plain GeLU FFN, full attention, no bias, no
    q/k norm, no MoE, no MLA."""
    return dataclasses.replace(cfg, qkv_bias=False, qk_norm=False, num_experts=0, act="gelu",
                               block_pattern=("attn",), mla=None)


def _init_encoder_block(cfg: ArchConfig, key: np.ndarray, dtype, device) -> dict:
    """An encoder block's params (attention, then FFN) under key words `key`
    (*lead, 2); `lead` = (layers,) stacks that many."""
    k1, k2 = split_keys(key, 2)
    ones = torch.ones((*k1.shape[:-1], cfg.d_model), dtype=dtype, device=device)
    return {"ln1": ones, "attn": attn.init_attention(cfg, k1, dtype, device),
            "ln2": ones.clone(), "ffn": init_ffn(cfg, k2, dtype, device)}


@functools.lru_cache(maxsize=4)
def _sinusoids(d_model: int) -> np.ndarray:
    """The encoder's position table (10,000 x d_model) in f64, built as the
    reference builds it: sines of every even-indexed frequency, then cosines.
    Read-only: every caller shares the cached array."""
    pos = np.arange(10_000)[:, None] / (10_000 ** (np.arange(0, d_model, 2)[None, :] / d_model))
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=-1)
    table.setflags(write=False)
    return table


def _encoder_forward(cfg: ArchConfig, p: dict, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, d), the stub frontend's output -> encoder states
    (B, F, d): sinusoidal positions, then bidirectional blocks (blockwise
    attention, as the reference's), then a final norm."""
    dtype = _dtype(cfg)
    x = frames.to(dtype)
    F_enc = x.shape[1]
    pe = torch.tensor(_sinusoids(cfg.d_model)[:F_enc, :cfg.d_model], device=x.device)
    x = x + pe.to(dtype)
    enc_cfg = _encoder_cfg(cfg)
    leaves, treedef = tree_flatten(p["blocks"])
    for layer in zip(*(leaf.unbind(0) for leaf in leaves)):
        bp = tree_unflatten(treedef, list(layer))
        y = attn.local_heads(lambda q, k, v: attn.blockwise_attention(q, k, v, causal=False),
                             *_enc_qkv(enc_cfg, bp["attn"], _norm(x, bp["ln1"], cfg.norm_eps)))
        x = x + _like(layout_grad(y.reshape(x.shape[0], F_enc, -1)) @ bp["attn"]["wo"], x)
        x = x + _like(ffn_forward(enc_cfg, bp["ffn"], _norm(x, bp["ln2"], cfg.norm_eps)), x)
    return _norm(x, p["norm"], cfg.norm_eps)


def _enc_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """The encoder's q, k, v (B, F, heads, hd): no bias, no RoPE."""
    B, T, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return (attn.split_heads(x @ p["wq"], B, T, h, hd),
            attn.split_heads(x @ p["wk"], B, T, hkv, hd),
            attn.split_heads(x @ p["wv"], B, T, hkv, hd))


def _embed_inputs(cfg: ArchConfig, params: dict, batch: dict):
    """-> (x (B, T', d), the encoder's output or None, n_prefix): the token
    embeddings, after the projected patches of a VLM (T' = patches +
    tokens, n_prefix = patches)."""
    x = _stream(F.embedding(batch["tokens"].long(), params["embed"]), batch["tokens"])
    enc_out, n_prefix = None, 0
    if cfg.is_encoder_decoder:
        enc_out = _encoder_forward(cfg, params["encoder"], batch["frames"])
    if cfg.num_patches:
        patches = batch["patches"].to(_dtype(cfg)) @ params["projector"]
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    return x, enc_out, n_prefix


def super_block(cfg: ArchConfig, moe_method: str, treedefs: tuple, cross: bool,
                h: torch.Tensor, *tensors) -> tuple[torch.Tensor, torch.Tensor]:
    """One superblock: the layers of `cfg.block_pattern` in turn, and the
    sum of their aux losses.  `tensors` are the encoder's output when
    `cross`, then the layers' tensors in pattern order, `treedefs` their
    structures."""
    enc_out, leaves = (tensors[0], tensors[1:]) if cross else (None, tensors)
    i, aux = 0, torch.zeros((), dtype=torch.float32, device=h.device)
    for kind, (treedef, n) in zip(cfg.block_pattern, treedefs):
        h, a = block_forward(cfg, kind, tree_unflatten(treedef, list(leaves[i:i + n])), h,
                             enc_out=enc_out, moe_method=moe_method)
        aux = aux + a
        i += n
    return h, aux


class _SaveDots(TorchDispatchMode):
    """Appends the output of every `aten.mm` run inside it to `saved`."""

    def __init__(self, saved: list):
        super().__init__()
        self.saved = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.mm.default:
            self.saved.append(out)
        return out


class _ReplayDots(TorchDispatchMode):
    """Answers the i-th `aten.mm` with the i-th kept output instead of
    running it: the recompute runs the block's ops in the forward's order."""

    def __init__(self, saved):
        super().__init__()
        self.saved, self.i = saved, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default and self.i < len(self.saved):
            self.i += 1
            return self.saved[self.i - 1].detach()
        return func(*args, **(kwargs or {}))


class RematBlock(torch.autograd.Function):
    """A superblock that keeps no activations: the forward saves its
    inputs only (the activations, the encoder's output when `cross`, and the
    layer tensors), and the backward recomputes the block under
    `torch.func.vjp` and pulls both cotangents (activations and aux loss)
    back through it, to every input: the encoder's output gets its
    cotangent, so the encoder's parameters get their gradient.  The vmap
    rule is generated, so it runs under the engine's vmap over clients; a
    flash attention call inside it runs its kernel again in the recompute.
    With `dots` (a fresh list, under `DOTS_SAVEABLE`) the forward also
    keeps the outputs of its 2-D-weight products there, as the dispatch
    mode below every transform sees them, for the recompute."""

    generate_vmap_rule = True

    @staticmethod
    def forward(cfg, moe_method, treedefs, cross, dots, h, *tensors):
        with _SaveDots(dots) if dots is not None else contextlib.nullcontext():
            return super_block(cfg, moe_method, treedefs, cross, h, *tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        cfg, moe_method, treedefs, cross, dots, h, *tensors = inputs
        ctx.cfg, ctx.moe_method, ctx.treedefs, ctx.cross = cfg, moe_method, treedefs, cross
        ctx.dots = dots
        ctx.h_layout = None
        if hasattr(h, "device_mesh") and "model" in h.device_mesh.mesh_dim_names:
            h, ctx.h_layout = _split_saved(h)
        ctx.save_for_backward(h, *tensors)

    @staticmethod
    def backward(ctx, ct_h, ct_aux):
        saved = ctx.saved_tensors
        if ctx.h_layout is not None:
            saved = (saved[0].redistribute(saved[0].device_mesh, ctx.h_layout), *saved[1:])

        def block(*xs):
            return super_block(ctx.cfg, ctx.moe_method, ctx.treedefs, ctx.cross, *xs)

        with _ReplayDots(ctx.dots) if ctx.dots else contextlib.nullcontext():
            if hasattr(saved[0], "device_mesh"):
                # DTensors (a model mesh): plain autograd, under which they
                # stay DTensors and keep their layouts (torch.func would wrap
                # them)
                with torch.enable_grad():
                    xs = [t.detach().requires_grad_() for t in saved]
                    outs = [(o, ct) for o, ct in zip(block(*xs), (ct_h, ct_aux))
                            if o.requires_grad]
                    grads = torch.autograd.grad([o for o, _ in outs], xs,
                                                [ct for _, ct in outs], allow_unused=True)
            else:
                _, pullback = vjp(block, *saved)
                grads = pullback((ct_h, ct_aux))
        return (None, None, None, None, None, *grads)


def _split_saved(h):
    """A remat block's saved input on a model mesh, kept split over "model"
    on its last axis (a copy of this rank's slice, so the whole stream is
    freed) where it is whole there and the axis divides; the backward
    gathers it back.  Returns (what to save, the layout to restore, or None
    to save `h` as it is)."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = h.device_mesh
    m = mesh.mesh_dim_names.index("model")
    if not h.placements[m].is_replicate() or h.shape[-1] % mesh.size(m) or mesh.size(m) == 1:
        return h, None
    pl = list(h.placements)
    pl[m] = Shard(h.ndim - 1)
    part = h.detach().redistribute(mesh, pl)
    return (DTensor.from_local(part.to_local().clone(), mesh, pl, run_check=False,
                               shape=part.shape, stride=part.stride()), tuple(h.placements))


def _stacked_layers(cfg: ArchConfig, params: dict) -> tuple[tuple, list[list]]:
    """(treedefs, per-layer leaves) of the superblocks.  One unbind per
    stacked leaf: its backward stacks the layers' grads once, where
    indexing each layer fills and adds a zero tensor of the whole stack per
    layer."""
    n_super, _ = _layout(cfg)
    stacks = []
    for pos in range(len(cfg.block_pattern) if n_super else 0):
        leaves, treedef = tree_flatten(params["super"][pos])
        stacks.append((treedef, [leaf.unbind(0) for leaf in leaves]))
    treedefs = tuple((treedef, len(layers)) for treedef, layers in stacks)
    return treedefs, [[u[r] for _, layers in stacks for u in layers] for r in range(n_super)]


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False,
            moe_method: str = "expert_choice", remat_policy: str | None = None,
            last_only: bool = False, hidden: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, T, V), or (B, 1, V) with `last_only`, aux loss).
    The logits are the tokens' only: a VLM's patch positions are sliced
    off after the final norm.  `remat` recomputes each superblock in the
    backward pass (`RematBlock`), keeping the 2-D-weight products with
    `remat_policy=DOTS_SAVEABLE`; `last_only` slices the hidden state to
    the last position before the LM head, so a prefill never holds (B, T,
    V) logits; `hidden` returns the normed hidden state the LM head takes
    instead of the logits."""
    if remat_policy not in (None, DOTS_SAVEABLE):
        raise ValueError(f"unknown remat policy {remat_policy!r}")
    x, enc_out, n_prefix = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_super, n_tail = _layout(cfg)
    treedefs, layers = _stacked_layers(cfg, params)
    cross = enc_out is not None
    enc = (enc_out,) if cross else ()
    for leaves in layers:
        if remat:
            dots = [] if remat_policy else None
            x, a = RematBlock.apply(cfg, moe_method, treedefs, cross, dots, x, *enc, *leaves)
        else:
            x, a = super_block(cfg, moe_method, treedefs, cross, x, *enc, *leaves)
        aux = aux + a
    plen = len(cfg.block_pattern)
    for i in range(n_tail):
        x, a = block_forward(cfg, cfg.block_kind(n_super * plen + i), params["tail"][i], x,
                             enc_out=enc_out, moe_method=moe_method)
        aux = aux + a
    x = _norm(x, params["final_norm"], cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    if last_only:
        x = x[:, -1:]
    return (x if hidden else x @ _head(cfg, params)), aux


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False,
            moe_method: str = "expert_choice", remat_policy: str | None = None
            ) -> torch.Tensor:
    """Mean next-token cross entropy, plus 0.3 x the multi-token prediction
    loss when `cfg.mtp_depth` is set, plus the MoE aux loss."""
    h, aux = forward(cfg, params, batch, remat=remat, moe_method=moe_method,
                     remat_policy=remat_policy, hidden=True)
    loss = _head_loss(cfg, params, h, batch["labels"])
    if cfg.mtp_depth:
        loss = loss + 0.3 * _mtp_loss(cfg, params, batch)
    return loss + aux


def _mtp_loss(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction, depth 1, as the reference
    computes it: the token and next-token embeddings, each normed, fused by
    `proj`, through one extra "attn" block (default expert-choice routing,
    its aux loss dropped, never rematerialised) and the LM head, scored
    against the labels shifted left by one with the last label repeated."""
    tokens, labels = batch["tokens"], batch["labels"]
    m = params["mtp"]
    x = _norm(F.embedding(tokens.long(), params["embed"]), m["norm"], cfg.norm_eps)
    nxt = _norm(F.embedding(labels.long(), params["embed"]), m["norm"], cfg.norm_eps)
    h, _ = block_forward(cfg, "attn", m["block"], torch.cat([x, nxt], dim=-1) @ m["proj"])
    l2 = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
    return _head_loss(cfg, params, h, l2)


def _head_loss(cfg: ArchConfig, params: dict, h: torch.Tensor, labels: torch.Tensor
               ) -> torch.Tensor:
    """Mean cross entropy of the LM head's logits of `h`.  On a model mesh
    (DTensors) it is the vocab-parallel loss, each rank's logits local."""
    if hasattr(h, "device_mesh"):
        return _vocab_parallel_loss(h, _head(cfg, params), labels)
    return cross_entropy_loss(h @ _head(cfg, params), labels)


def _vocab_parallel_loss(h, head, labels) -> torch.Tensor:
    """Megatron's vocab-parallel cross entropy through `local_map`: each rank
    computes its tokens' logits over its vocab slice (the head split on
    "model" where the vocab divides; else the tokens are split over "model"
    too, where the batch divides), the max, the sum of exponentials and
    the label's logit are reduced over "model", and the token sum over the
    batch axes: no (B, T, V) tensor leaves its rank.  Left to DTensor's
    sharding propagation, the logits' backward comes back in strided
    layouts its propagation cannot take."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.common import ContiguousGrad, Sum, SumGrad, all_reduce

    mesh = h.device_mesh
    names, sizes = mesh.mesh_dim_names, mesh.shape
    batch_dims = [i for i, p in enumerate(labels.placements) if p.is_shard(0)]
    m_dim = names.index("model") if "model" in names else None
    split = m_dim is not None and head.shape[1] % sizes[m_dim] == 0 and sizes[m_dim] > 1
    if (m_dim is not None and not split and sizes[m_dim] > 1
            and labels.shape[0] % math.prod(sizes[i] for i in batch_dims + [m_dim]) == 0):
        # a vocab that "model" does not divide: each model rank scores a
        # share of the tokens over the whole vocab, not all of them
        batch_dims.append(m_dim)
    rep = [Replicate()] * len(names)
    h_pl = [Shard(0) if i in batch_dims else Replicate() for i in range(len(names))]
    head_pl = [Shard(1) if split and i == m_dim else Replicate() for i in range(len(names))]
    model = mesh.get_group(names[m_dim]) if split else None
    batch_groups = [mesh.get_group(names[i]) for i in batch_dims]
    V_loc = head.shape[1] // (sizes[m_dim] if split else 1)
    v0 = mesh.get_local_rank(names[m_dim]) * V_loc if split else 0
    n_tokens = labels.numel()

    def local(h, head, labels):
        h, head = ContiguousGrad.apply(h), ContiguousGrad.apply(head)
        if split:  # every model rank scores these tokens on its own slice
            h = SumGrad.apply(h, model)
        for g in batch_groups:  # every batch shard uses the head on its tokens
            head = SumGrad.apply(head, g)
        logits = (h @ head).float()
        m = logits.amax(dim=-1, keepdim=True).detach()
        if split:
            m = all_reduce(m, model, "max")
        se = torch.sum(torch.exp(logits - m), dim=-1, keepdim=True)
        lab = labels.long()[..., None] - v0
        inside = (lab >= 0) & (lab < V_loc)
        ll = torch.gather(logits, -1, lab.clamp(0, V_loc - 1)) * inside
        if split:
            se, ll = Sum.apply(se, model), Sum.apply(ll, model)
        total = torch.sum(m + torch.log(se) - ll)
        for g in batch_groups:
            total = Sum.apply(total, g)
        return total / n_tokens

    return local_map(local, out_placements=rep, in_placements=(h_pl, head_pl, h_pl),
                     device_mesh=mesh, redistribute_inputs=True)(h, head, labels)


def sgd_update(params: dict, grads, lr: float) -> dict:
    """p - lr * g, computed in f32 and rounded to each leaf's dtype (`torch.add`
    with alpha), as the reference's step with an f32 learning rate.

    `grads` is a tree of the params' structure, or the list of its leaves
    (`tree_leaves` order), which the update empties as it goes: each
    gradient is then freed as soon as its new leaf is made, so a step holds
    the params, the gradients and one new leaf at once, not the params
    twice beside the gradients."""
    leaves, treedef = tree_flatten(params)
    g = grads if isinstance(grads, list) and all(
        isinstance(t, torch.Tensor) for t in grads) else tree_leaves(grads)
    new = []
    for i, p in enumerate(leaves):
        new.append(torch.add(p, g[i], alpha=-lr))
        g[i] = None
    return tree_unflatten(treedef, new)


def make_train_step(cfg: ArchConfig, *, remat: bool = True, moe_method: str = "expert_choice"):
    """Plain SGD step, the Eq. (5)-compatible unit the FL layer composes:
    (params, batch, lr) -> (new params, loss)."""

    def train_step(params: dict, batch: dict, lr: float):
        grads, loss = grad_and_value(
            lambda p: loss_fn(cfg, p, batch, remat=remat, moe_method=moe_method))(params)
        grads = tree_leaves(grads)  # the only reference: the update frees each in turn
        return sgd_update(params, grads, lr), loss

    return train_step


# ==========================================================================
# serving: caches, single-token decode, prefill
# ==========================================================================


def init_caches(cfg: ArchConfig, batch: int, capacity: int, *, enc_len: int = 0,
                device=None) -> dict:
    """Empty decode caches for `batch` sequences of up to `capacity` tokens
    (and an encoder-decoder's cross caches over `enc_len` frames), on
    `device` (the card unless asked): {"super": per pattern position, the
    layers' caches stacked on axis 0; "tail": one per remainder layer}."""
    device = resolve_device(device)
    dtype = _dtype(cfg)
    n_super, n_tail = _layout(cfg)
    plen = len(cfg.block_pattern)
    super_caches = [
        tree_map(lambda *xs: torch.stack(xs),
                 *[init_block_cache(cfg, kind, batch, capacity, dtype, device, enc_len)
                   for _ in range(n_super)])
        for kind in cfg.block_pattern] if n_super else []
    tail = [init_block_cache(cfg, cfg.block_kind(n_super * plen + i), batch, capacity, dtype,
                             device, enc_len) for i in range(n_tail)]
    return {"super": super_caches, "tail": tail}


def _map_named(tree, name: str, fn):
    """`tree` with `fn` applied to every leaf stored under the key `name`."""
    if isinstance(tree, dict):
        return {k: fn(v) if k == name else _map_named(v, name, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, name, fn) for v in tree)
    return tree


def set_cache_len(caches: dict, new_len: int) -> dict:
    """Mark caches as holding `new_len` tokens."""
    return _map_named(caches, "len", lambda t: torch.full_like(t, new_len))


def decode_step(cfg: ArchConfig, params: dict, caches: dict, token: torch.Tensor, *,
                moe_method: str = "expert_choice") -> tuple[torch.Tensor, dict]:
    """token (B, 1) int -> (logits (B, V), new caches): one new token
    against the caches.  The caches passed in are not written."""
    x = F.embedding(token.long(), params["embed"])
    plen = len(cfg.block_pattern)
    n_super, n_tail = _layout(cfg)
    treedefs, layers = _stacked_layers(cfg, params)
    cache_defs, cache_layers = _stacked_layers(cfg, caches)
    new_layers = []
    for leaves, cache_leaves in zip(layers, cache_layers):
        i, j, new_leaves = 0, 0, []
        for kind, (treedef, n), (cache_def, m) in zip(cfg.block_pattern, treedefs, cache_defs):
            x, nc = block_decode(cfg, kind, tree_unflatten(treedef, leaves[i:i + n]), x,
                                 tree_unflatten(cache_def, cache_leaves[j:j + m]),
                                 moe_method=moe_method)
            new_leaves += tree_flatten(nc)[0]
            i, j = i + n, j + m
        new_layers.append(new_leaves)
    new_super, j = [], 0
    for (cache_def, m), stacks in zip(cache_defs, caches["super"]):
        new_super.append(tree_unflatten(cache_def, [
            _restack(xs, like) for xs, like in zip(
                zip(*(ls[j:j + m] for ls in new_layers)), tree_leaves(stacks))]))
        j += m
    new_tail = []
    for i in range(n_tail):
        x, nc = block_decode(cfg, cfg.block_kind(n_super * plen + i), params["tail"][i], x,
                             caches["tail"][i], moe_method=moe_method)
        new_tail.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ _head(cfg, params))[:, 0], {"super": new_super, "tail": new_tail}


def _restack(layers, like: torch.Tensor) -> torch.Tensor:
    """The layers' new caches stacked on a leading axis.  On a model mesh
    each layer's shard is stacked where it lies, under the placements of
    the stack it came from (`like`), so no step moves the whole stack."""
    if not hasattr(like, "device_mesh"):
        return torch.stack(layers)
    from torch.distributed.tensor import DTensor, Shard

    per_layer = [Shard(p.dim - 1) if p.is_shard() else p for p in like.placements]
    local = torch.stack([t.redistribute(like.device_mesh, per_layer).to_local()
                         for t in layers])
    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def prefill(cfg: ArchConfig, params: dict, batch: dict, *, capacity: int | None = None,
            moe_method: str = "expert_choice") -> tuple[torch.Tensor, dict]:
    """Run the whole prompt: (last-position logits (B, V), caches filled
    with it, room for `capacity` tokens (default the prompt's length)).
    The LM head sees only the last position (`last_only`), so no (B, T, V)
    logits are made.  An encoder-decoder's cross caches hold the encoder's
    K/V of `batch["frames"]`.  The replay feeds the tokens only, as the
    reference's does: a VLM's caches never hold its patch positions."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    logits, _ = forward(cfg, params, batch, moe_method=moe_method, last_only=True)
    enc_len = batch["frames"].shape[1] if cfg.is_encoder_decoder else 0
    caches = init_caches(cfg, B, capacity or T, enc_len=enc_len, device=tokens.device)
    if cfg.is_encoder_decoder:
        caches = _fill_cross_caches(cfg, params, batch, caches)
    caches = _fill_caches_by_replay(cfg, params, batch, caches, moe_method=moe_method)
    return logits[:, -1], caches


def _fill_cross_caches(cfg: ArchConfig, params: dict, batch: dict, caches: dict) -> dict:
    """The caches with every attention block's cross_k/cross_v set to the
    encoder's K/V of `batch["frames"]`, computed once per request."""
    enc_out = _encoder_forward(cfg, params["encoder"], batch["frames"])
    B, F_enc, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim

    def fill(pp: dict, cc: dict) -> dict:
        if "xattn" not in pp:
            return cc
        wk, wv = pp["xattn"]["wk"], pp["xattn"]["wv"]
        if wk.ndim == 3:  # stacked (L, d, hkv*hd)
            ck = torch.einsum("bfd,ldk->lbfk", enc_out, wk).reshape(wk.shape[0], B, F_enc, hkv, hd)
            cv = torch.einsum("bfd,ldk->lbfk", enc_out, wv).reshape(wv.shape[0], B, F_enc, hkv, hd)
        else:
            ck = (enc_out @ wk).reshape(B, F_enc, hkv, hd)
            cv = (enc_out @ wv).reshape(B, F_enc, hkv, hd)
        return dict(cc, cross_k=ck.to(cc["cross_k"].dtype), cross_v=cv.to(cc["cross_v"].dtype))

    return {"super": [fill(pp, cc) for pp, cc in zip(params["super"], caches["super"])],
            "tail": [fill(pp, cc) for pp, cc in zip(params["tail"], caches["tail"])]}


def _fill_caches_by_replay(cfg: ArchConfig, params: dict, batch: dict, caches: dict, *,
                           moe_method: str) -> dict:
    """Decode the prompt token by token to fill the caches (the reference's
    "reference-quality path": one decode step per prompt token)."""
    tokens = batch["tokens"]
    for t in range(tokens.shape[1]):
        _, caches = decode_step(cfg, params, caches, tokens[:, t:t + 1], moe_method=moe_method)
    return caches
