"""GQA self-attention, full or sliding-window, and DeepSeek's multi-head
latent attention (MLA) (port of `repro/models/attention.py`).

Training attention is *blockwise*: an online softmax over KV chunks, so the
(T, S) score matrix is never held whole.  With `cfg.use_flash` it goes
through the flash-attention kernel instead (`FlashAttention`): the forward
is the kernel, and the backward recomputes attention with this module's
blockwise path and differentiates that, as the reference's
`_flash_attention_ad` does.  Residuals are (q, k, v) only.

`FlashAttention` is a `torch.autograd.Function` with a `vmap` rule, so it
composes with `torch.func.vmap(grad_and_value(loss))`, the engine's
per-client step: the rule folds the vmapped client axis into the batch
axis, and one kernel launch serves every client of a step.  (A
`torch.library.custom_op` with `register_autograd` cannot run under
`torch.func` transforms: its generated autograd function has no
`setup_context`.)

Decode attends one query against a fixed-capacity cache: full caches are
written at `len` (clamped to the last slot), sliding-window caches are ring
buffers written at `len % S`.  Decode attention is plain torch in f32, as
the reference's is plain jnp.

MLA's training path (`mla_forward`) materialises per-head K/V from the
latent and runs the blockwise path whatever `cfg.use_flash` says, as the
reference does: its q/k heads (nope + rope) are wider than its v heads,
which `blockwise_attention` takes (`hd_v`).  Its decode (`mla_decode`) is
the absorbed form over a cache of the latent and the shared rope key only.

Shapes: x (B, T, D); q (B, T, H, hd); kv (B, S, Hkv, hd); caches
(B, S, Hkv, hd).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.func import vjp

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (ContiguousGrad, apply_rope, dense_init, rms_norm,
                                      rope_angles)

NEG_INF = -1e30


def init_attention(cfg: ArchConfig, gen: torch.Generator, dtype, lead: tuple = ()) -> dict:
    """Attention params; `lead` = (layers,) stacks that many blocks."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, h * hd, lead=lead, dtype=dtype),
        "wk": dense_init(gen, d, hkv * hd, lead=lead, dtype=dtype),
        "wv": dense_init(gen, d, hkv * hd, lead=lead, dtype=dtype),
        "wo": dense_init(gen, h * hd, d, lead=lead, dtype=dtype),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h * hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((*lead, hkv * hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((*lead, hkv * hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=dev)
    return p


def init_mla(cfg: ArchConfig, gen: torch.Generator, dtype, lead: tuple = ()) -> dict:
    """MLA params (the reference's leaves); `lead` = (layers,) stacks that
    many blocks.  Drawn query projections first, then the latent K/V and
    the output projection."""
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = dense_init(gen, d, m.q_lora_rank, lead=lead, dtype=dtype)
        p["q_norm"] = torch.ones((*lead, m.q_lora_rank), dtype=dtype, device=dev)
        p["wq_b"] = dense_init(gen, m.q_lora_rank, h * qk_head, lead=lead, dtype=dtype)
    else:
        p["wq"] = dense_init(gen, d, h * qk_head, lead=lead, dtype=dtype)
    p["wkv_a"] = dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, lead=lead, dtype=dtype)
    p["kv_norm"] = torch.ones((*lead, m.kv_lora_rank), dtype=dtype, device=dev)
    p["wkv_b"] = dense_init(gen, m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim),
                            lead=lead, dtype=dtype)
    p["wo"] = dense_init(gen, h * m.v_head_dim, d, lead=lead, dtype=dtype)
    return p


def blockwise_attention(q, k, v, *, causal: bool, window: int | None = None,
                        kv_block: int = 512, q_offset: int = 0):
    """Online-softmax attention. q (B,T,H,hd), k/v (B,S,Hkv,hd) -> (B,T,H,hd).

    Loops over S in `kv_block` chunks keeping running (max, sum, acc), as
    the reference's `lax.scan` does.  GQA: H % Hkv == 0, kv heads broadcast.
    `q_offset`: absolute position of q[0] (0 for training)."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    pad = (-S) % kv_block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nblk = (S + pad) // kv_block

    qf = (q * scale).float().reshape(B, T, Hkv, g, hd)
    kf, vf = k.float(), v.float()
    q_pos = q_offset + torch.arange(T, device=q.device)
    m = torch.full((B, T, Hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, T, Hkv, g), dtype=torch.float32, device=q.device)  # noqa: E741
    acc = torch.zeros((B, T, Hkv, g, hd_v), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kblk = kf[:, i * kv_block:(i + 1) * kv_block]
        vblk = vf[:, i * kv_block:(i + 1) * kv_block]
        kv_pos = i * kv_block + torch.arange(kv_block, device=q.device)
        s = torch.einsum("bthgd,bshd->bthgs", qf, kblk)
        mask = (kv_pos[None, :] < S).expand(T, kv_block)  # padding
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)  # noqa: E741
        acc = acc * corr[..., None] + torch.einsum("bthgs,bshd->bthgd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, T, H, hd_v).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the kernel's forward, the blockwise
    path's backward (recomputed from the residuals q, k, v).  The backward
    launches no kernel: the reference has no backward kernel either."""

    @staticmethod
    def forward(q, k, v, causal: bool, window: int | None):
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, ct):
        q, k, v = ctx.saved_tensors
        _, pullback = vjp(
            lambda q, k, v: blockwise_attention(q, k, v, causal=ctx.causal, window=ctx.window),
            q, k, v)
        return (*pullback(ct), None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        """Fold the vmapped axis into the batch axis: one launch for all."""
        n = info.batch_size

        def folded(x, dim):
            x = x.movedim(dim, 0) if dim is not None else x.expand(n, *x.shape)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        q, k, v = (folded(x, d) for x, d in zip((q, k, v), in_dims[:3]))
        out = FlashAttention.apply(q, k, v, causal, window)
        return out.reshape(n, -1, *out.shape[1:]), 0


def split_heads(t, B: int, T: int, n: int, hd: int):
    """(B, T, n * hd) -> (B, T, n, hd).  On a model mesh a feature split that
    the n heads do not divide (8 kv heads over 16 ranks) is gathered first:
    DTensor cannot split heads unevenly."""
    if hasattr(t, "device_mesh"):
        from torch.distributed.tensor import Replicate

        pl = [Replicate() if p.is_shard(t.ndim - 1) and n % size else p
              for p, size in zip(t.placements, t.device_mesh.shape)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(B, T, n, hd)


def _project_qkv(cfg: ArchConfig, p, x, positions):
    B, T, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (split_heads(q, B, T, h, hd), split_heads(k, B, T, hkv, hd),
               split_heads(v, B, T, hkv, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def local_heads(attend, q, *kv, batch: tuple = (), n_out: int = 1, repeat_kv: bool = True):
    """`attend(q, *kv, *batch)` on each rank's heads: q (B, T, H, ...), the
    tensors of `kv` (k, v, caches: (B, S, Hkv, ...)), `batch` tensors with
    the batch on their first axis; it returns `n_out` tensors in q's layout.
    On plain tensors it is the call itself.  On DTensors (a model mesh) it
    runs through `local_map`: the batch split as q's is, the heads split
    over "model" where they divide (where only the query heads do, the kv
    heads are repeated to them first with `repeat_kv`, else nothing is
    split over "model"), every other mesh dim whole.  Attention mixes no
    heads, so each rank's share is the one-device computation on its
    heads; left to DTensor's sharding propagation, GQA's head grouping
    gathers q, k and v whole, and the flash op has no sharding rule."""
    if not hasattr(q, "device_mesh"):
        return attend(q, *kv, *batch)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, Hkv = q.shape[2], kv[0].shape[2]
    pl = []
    for name, n, cur in zip(mesh.mesh_dim_names, mesh.shape, q.placements):
        if cur.is_shard(0):
            pl.append(Shard(0))
        elif name == "model" and H % n == 0 and (repeat_kv or Hkv % n == 0):
            pl.append(Shard(2))
            if Hkv % n:
                kv = tuple(t.repeat_interleave(H // Hkv, dim=2) for t in kv)
        else:
            pl.append(Replicate())
    pl = tuple(pl)
    batch_pl = tuple(p if p.is_shard(0) else Replicate() for p in pl)
    # a plain batch tensor (made inside the step) is whole on every rank
    batch = tuple(b if hasattr(b, "device_mesh") else DTensor.from_local(
        b, mesh, [Replicate()] * len(pl), run_check=False) for b in batch)

    def local(*args):
        heads = args[:1 + len(kv)]
        return attend(*(ContiguousGrad.apply(t) for t in heads), *args[1 + len(kv):])

    out_pl = list(pl) if n_out == 1 else (pl,) * n_out
    return local_map(local, out_placements=out_pl,
                     in_placements=(pl,) * (1 + len(kv)) + (batch_pl,) * len(batch),
                     device_mesh=mesh, redistribute_inputs=True)(q, *kv, *batch)


def attention_forward(cfg: ArchConfig, p, x, *, window: int | None = None):
    """Training self-attention (causal)."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _project_qkv(cfg, p, x, positions)
    if cfg.use_flash:
        out = local_heads(lambda q, k, v: FlashAttention.apply(q, k, v, True, window), q, k, v)
    else:
        out = local_heads(
            lambda q, k, v: blockwise_attention(q, k, v, causal=True, window=window), q, k, v)
    return out.reshape(B, T, -1) @ p["wo"]


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int | None = None):
    """Single-step decode: q (B,1,H,hd) against caches (B,S,Hkv,hd) in f32;
    positions >= cache_len (B,) are masked.  A sliding-window cache is a
    ring buffer, so its live entries are all valid and `window` is already
    structural."""
    B, T, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qf = (q * scale).float().reshape(B, T, Hkv, g, hd)
    s = torch.einsum("bthgd,bshd->bthgs", qf, k_cache.float())
    valid = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bthgs,bshd->bthgd", p, v_cache.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def attention_decode(cfg: ArchConfig, p, x, cache: dict, *, window: int | None = None):
    """One-token decode. cache = {"k": (B,S,Hkv,hd), "v": ..., "len": (B,)}
    -> (y (B,1,D), new cache); the cache passed in is not written."""
    B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"decode takes one token per sequence, got {T}")
    q, k, v = _project_qkv(cfg, p, x, cache["len"][:, None])
    S = cache["k"].shape[1]

    def step(q, k, v, k_cache, v_cache, lens):
        # the cache write and the attention, per rank on a model mesh
        slot = lens % S if window is not None else torch.clamp(lens, max=S - 1)
        at = (torch.arange(q.shape[0], device=q.device), slot.long())
        k_cache = k_cache.index_put(at, k[:, 0])
        v_cache = v_cache.index_put(at, v[:, 0])
        eff_len = torch.clamp(lens + 1, max=S) if window is not None else lens + 1
        return decode_attention(q, k_cache, v_cache, eff_len, window=window), k_cache, v_cache

    if _seq_split(cache["k"]) is not None:
        out, k_cache, v_cache = _decode_seq_split(q, k, v, cache, window)
    else:
        out, k_cache, v_cache = local_heads(step, q, k, v, cache["k"], cache["v"],
                                            batch=(cache["len"],), n_out=3, repeat_kv=False)
    new_len = cache["len"] + 1
    return out.reshape(B, T, -1) @ p["wo"], {"k": k_cache, "v": v_cache, "len": new_len}


def _seq_split(k_cache):
    """The mesh dim splitting a DTensor cache's sequence axis (the
    sequence-parallel layout `cache_pspecs` gives kv heads that do not
    divide "model"), or None."""
    if not hasattr(k_cache, "device_mesh"):
        return None
    hits = [i for i, p in enumerate(k_cache.placements) if p.is_shard(1)]
    return hits[0] if hits else None


def _decode_seq_split(q, k, v, cache: dict, window: int | None):
    """Decode against a cache whose sequence axis is split over the ranks of
    one mesh dim (flash-decode style): each rank writes the new token only
    where it owns the slot, scores its share of the positions, and the
    softmax's max, sum and weighted values are reduced over that dim, so no
    rank gathers the cache.  The same softmax as `decode_attention`, its
    sums in another order."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.common import all_reduce

    mesh, dim = cache["k"].device_mesh, _seq_split(cache["k"])
    group, r = mesh.get_group(dim), mesh.get_local_rank(dim)
    S = cache["k"].shape[1]
    batch_pl = tuple(p if p.is_shard(0) else Replicate() for p in cache["len"].placements)
    cache_pl = tuple(Shard(1) if i == dim else p for i, p in enumerate(batch_pl))

    def local(q, k, v, k_cache, v_cache, lens):
        B, S_loc = k_cache.shape[:2]
        slot = (lens % S if window is not None else torch.clamp(lens, max=S - 1)).long()
        mine = (slot // S_loc) == r
        at = (torch.arange(B, device=q.device), (slot - r * S_loc).clamp(0, S_loc - 1))
        keep = mine[:, None, None]
        k_cache = k_cache.index_put(at, torch.where(keep, k[:, 0], k_cache[at]))
        v_cache = v_cache.index_put(at, torch.where(keep, v[:, 0], v_cache[at]))
        eff_len = torch.clamp(lens + 1, max=S) if window is not None else lens + 1
        H, hd = q.shape[2], q.shape[3]
        Hkv = k_cache.shape[2]
        qf = (q * (1.0 / math.sqrt(hd))).float().reshape(B, 1, Hkv, H // Hkv, hd)
        sc = torch.einsum("bthgd,bshd->bthgs", qf, k_cache.float())
        pos = r * S_loc + torch.arange(S_loc, device=q.device)
        valid = pos[None, :] < eff_len[:, None]
        sc = torch.where(valid[:, None, None, None, :], sc, torch.full_like(sc, NEG_INF))
        m = all_reduce(sc.amax(dim=-1, keepdim=True), group, "max")
        pr = torch.exp(sc - m)
        den = all_reduce(pr.sum(dim=-1, keepdim=True), group)
        num = all_reduce(torch.einsum("bthgs,bshd->bthgd", pr, v_cache.float()), group)
        out = (num / den[..., 0][..., None]).reshape(B, 1, H, hd).to(q.dtype)
        return out, k_cache, v_cache

    whole = tuple(batch_pl)
    args = [t if hasattr(t, "device_mesh") else DTensor.from_local(
        t, mesh, [Replicate()] * len(batch_pl), run_check=False) for t in (q, k, v)]
    return local_map(local, out_placements=(whole, cache_pl, cache_pl),
                     in_placements=(whole, whole, whole, cache_pl, cache_pl, batch_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        *args, cache["k"], cache["v"], cache["len"])


def init_attn_cache(cfg: ArchConfig, batch: int, capacity: int, dtype, device) -> dict:
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, capacity, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, capacity, hkv, hd), dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------


def _mla_q(cfg: ArchConfig, p, x, positions):
    """-> (q_nope (B,T,H,nope), q_rope (B,T,H,rope) rotated)."""
    m = cfg.mla
    B, T, _ = x.shape
    if m.q_lora_rank:
        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, T, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_latent(cfg: ArchConfig, p, x, positions):
    """-> (c_kv (B,T,r) normed, k_rope (B,T,1,rope) rotated)."""
    m = cfg.mla
    B, T, _ = x.shape
    c_kv, k_rope = (x @ p["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return (rms_norm(c_kv, p["kv_norm"], cfg.norm_eps),
            apply_rope(k_rope.reshape(B, T, 1, m.qk_rope_head_dim), cos, sin))


def mla_forward(cfg: ArchConfig, p, x):
    """Training / prefill MLA: per-head K/V materialised from the latent,
    then causal blockwise attention with q/k heads of nope + rope and v
    heads of `v_head_dim` (scale 1/sqrt(nope + rope))."""
    m = cfg.mla
    B, T, _ = x.shape
    h = cfg.num_heads
    positions = torch.arange(T, device=x.device).expand(B, T)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    kv = (c_kv @ p["wkv_b"]).reshape(B, T, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, T, h, m.qk_rope_head_dim)], dim=-1)
    out = local_heads(lambda q, k, v: blockwise_attention(q, k, v, causal=True),
                      torch.cat([q_nope, q_rope], dim=-1), k, v)
    return out.reshape(B, T, -1) @ p["wo"]


def mla_decode(cfg: ArchConfig, p, x, cache: dict):
    """Absorbed-form decode over the latent cache: score = q_nope W_uk c_kv
    + q_rope k_rope, out = (probs c_kv) W_uv.  cache = {"c_kv": (B,S,r),
    "k_rope": (B,S,rope), "len": (B,)} -> (y (B,1,D), new cache); the cache
    passed in is not written.  The casts are the reference's: the
    absorption and both score products in the params' dtype, their sum
    scaled and softmaxed in f32, the context cast back before W_uv."""
    m = cfg.mla
    B, T, _ = x.shape
    if T != 1:
        raise ValueError(f"decode takes one token per sequence, got {T}")
    h = cfg.num_heads
    positions = cache["len"][:, None]
    q_nope, q_rope = _mla_q(cfg, p, x, positions)  # (B,1,h,*)
    c_new, kr_new = _mla_latent(cfg, p, x, positions)
    S = cache["c_kv"].shape[1]
    at = (torch.arange(B, device=x.device), torch.clamp(cache["len"], max=S - 1).long())
    c_kv = cache["c_kv"].index_put(at, c_new[:, 0])
    k_rope = cache["k_rope"].index_put(at, kr_new[:, 0, 0])
    new_len = cache["len"] + 1

    w_uk, w_uv = p["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim) \
        .split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_abs = torch.einsum("bthd,rhd->bthr", q_nope, w_uk)
    s = torch.einsum("bthr,bsr->bths", q_abs, c_kv) + torch.einsum(
        "bthd,bsd->bths", q_rope, k_rope)
    s = s.float() * (1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    valid = torch.arange(S, device=x.device)[None, :] < new_len[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bths,bsr->bthr", probs, c_kv.float()).to(x.dtype)
    out = torch.einsum("bthr,rhd->bthd", ctx, w_uv)
    return out.reshape(B, T, -1) @ p["wo"], {"c_kv": c_kv, "k_rope": k_rope, "len": new_len}


def init_mla_cache(cfg: ArchConfig, batch: int, capacity: int, dtype, device) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, capacity, m.qk_rope_head_dim), dtype=dtype,
                              device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
