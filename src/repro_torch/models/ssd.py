"""Mamba-2 SSD (state-space duality) blocks, chunked (port of
`repro/models/ssd.py`).

The recurrence per head (scalar decay a_t, state S in R^{P x N}):
    S_t = a_t * S_{t-1} + x_t B_t^T          (x_t in R^P, B_t in R^N)
    y_t = S_t C_t + D * x_t                  (C_t in R^N)

Training and prefill run the chunked dual form, as the reference does: T
is cut into chunks of Q tokens, each chunk's own contribution is a masked
(Q x Q) product, and only the (H, P, N) state crosses chunks, in a loop
over the T/Q chunks where the reference scans (`ssd_chunked` emits the
state *entering* each chunk).  The reference's three-operand einsums are
written here as a broadcast product and a two-operand einsum, so they sum
in another order; results agree within float rounding.  Decode is the
recurrence itself, one token at a time (`ssd_decode_step`).

The block projects the wide x/z streams and the narrow B/C/dt streams
separately, as the reference does.  Its `A_log` and `dt_bias` leaves are
f32 whatever the model's dtype.  A mamba2 block has no FFN.

Layout: x (B, T, H, P); log_a (B, T, H) <= 0; B/C (B, T, N) (one group,
broadcast over heads).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.models.attention import local_heads
from repro_torch.models.common import dense_init, normal_leaf, rms_norm, silu, split_keys


def ssd_chunked(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), log_a (B,T,H) (log decay, <= 0), Bm/Cm (B,T,N), T a
    multiple of `chunk` -> (y (B,T,H,P) in x's dtype, final state (B,H,P,N)
    in f32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    if T % chunk:
        raise ValueError(f"T = {T} is not a multiple of the chunk {chunk}")
    nc = T // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P).float()
    lc = log_a.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, N).float()

    # cumulative log decay within each chunk: csum[t] = sum_{u<=t} log_a[u]
    csum = torch.cumsum(lc, dim=2)  # (B,nc,Q,H)

    # intra-chunk (dual, attention-like) term: M[t,s] = exp(csum[t] - csum[s])
    # for s <= t.  Both wheres are needed: a masked (s > t) entry of seg is
    # large and positive, exp overflows there, and exp's backward would
    # leak inf * 0 = NaN through a single where.
    seg = csum[:, :, :, None, :] - csum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    tri = tri[None, None, :, :, None]
    seg = torch.where(tri, seg, 0.0)
    M = torch.where(tri, torch.exp(seg), 0.0)
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", scores[..., None] * M, xc)

    # each chunk's own state: sum_s exp(csum[Q-1] - csum[s]) x_s B_s^T
    decay_to_end = torch.exp(csum[:, :, -1:, :] - csum)  # (B,nc,Q,H)
    S_c = torch.einsum("bcshp,bcsn->bchpn", decay_to_end[..., None] * xc, Bc)
    A_c = torch.exp(csum[:, :, -1, :])  # each chunk's total decay (B,nc,H)

    # across chunks: the state entering chunk c, and the final state
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = A_c[:, c, :, None, None] * state + S_c[:, c]
    S_in = torch.stack(entering, dim=1)  # (B,nc,H,P,N)

    # inter-chunk output: y_t += C_t . (exp(csum[t]) * S_in)
    y_inter = torch.einsum("bctn,bchpn->bcthp", Cc, S_in) * torch.exp(csum)[..., None]
    return (y_intra + y_inter).reshape(Bsz, T, H, P).to(x.dtype), state


def ssd_decode_step(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B,H,P), log_a (B,H), Bm/Cm (B,N), state (B,H,P,N) f32
    -> (y (B,H,P) in x's dtype, new state)."""
    a = torch.exp(log_a.float())[..., None, None]
    state = a * state + torch.einsum("bhp,bn->bhpn", x.float(), Bm.float())
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    return y.to(x.dtype), state


# --------------------------------------------------------------------------
# the Mamba-2 block (in_proj -> short conv -> SSD -> gated out_proj)
# --------------------------------------------------------------------------


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(d_in, N, H): inner width, state size, heads."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, d_in // cfg.ssm_head_dim


def init_ssd_block(cfg: ArchConfig, key: np.ndarray, dtype, device) -> dict:
    """The block's params under key words `key` (*lead, 2), as the
    reference draws them: `lead` = (layers,) stacks that many blocks.
    `A_log` and `dt_bias` are f32; `A_log` is log(linspace(1, 16, H)) with
    XLA's f32 linspace and log."""
    d = cfg.d_model
    d_in, N, H = _dims(cfg)
    ks = split_keys(key, 7)
    lead = ks[0].shape[:-1]
    a_log = torch.from_numpy(prng.log(prng.linspace(1.0, 16.0, H)))
    return {
        # wide streams: z (gate) and x
        "w_in": dense_init(ks[0], d, 2 * d_in, dtype=dtype, device=device),
        "conv_w": normal_leaf(ks[1], (cfg.ssm_conv, d_in), 0.2, dtype, device),
        "conv_b": torch.zeros((*lead, d_in), dtype=dtype, device=device),
        # narrow streams: B, C (state projections) and dt
        "w_bc": dense_init(ks[2], d, 2 * N, dtype=dtype, device=device),
        "conv_bc_w": normal_leaf(ks[3], (cfg.ssm_conv, 2 * N), 0.2, dtype, device),
        "conv_bc_b": torch.zeros((*lead, 2 * N), dtype=dtype, device=device),
        "w_dt": dense_init(ks[5], d, H, dtype=dtype, device=device),
        "A_log": a_log.to(device).expand(*lead, -1).clone(),
        "dt_bias": torch.zeros((*lead, H), dtype=torch.float32, device=device),
        "D": torch.ones((*lead, H), dtype=dtype, device=device),
        "norm": torch.ones((*lead, d_in), dtype=dtype, device=device),
        "w_out": dense_init(ks[6], d_in, d, dtype=dtype, device=device),
    }


def _causal_conv(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv and SiLU: xs (B,T,C), w (K,C)."""
    K, T = w.shape[0], xs.shape[1]
    pad = F.pad(xs, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + T, :] * w[i] for i in range(K))
    return silu(out + b)


def _split_cols(w: torch.Tensor) -> torch.Tensor:
    """A weight that the reference's specs leave whole (the narrow B, C and
    dt projections), split by columns over "model" on a model mesh where
    they divide, so that no rank repeats its product; a plain tensor
    passes through."""
    if not hasattr(w, "device_mesh") or "model" not in w.device_mesh.mesh_dim_names:
        return w
    from torch.distributed.tensor import Shard

    m = w.device_mesh.mesh_dim_names.index("model")
    if not w.placements[m].is_replicate() or w.shape[-1] % w.device_mesh.size(m):
        return w
    pl = list(w.placements)
    pl[m] = Shard(w.ndim - 1)
    return w.redistribute(w.device_mesh, pl)


def _streams(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """x (..., d) -> (z, x stream, bc, dt)."""
    d_in = _dims(cfg)[0]
    z, xs = (x @ p["w_in"]).split([d_in, d_in], dim=-1)
    return z, xs, x @ _split_cols(p["w_bc"]), x @ _split_cols(p["w_dt"])


def _keep_state_split(state, x, Bm, Cm):
    """On a model mesh whose state cache is split on N over "model"
    (`sharding.specs.cache_pspecs`), x whole and B, C split on N as the
    state is, so that the step's update and read stay on each rank's N
    columns (y a partial sum over "model", one all-reduce of (B, H, P)),
    as the reference's program keeps them; left to DTensor, x's head split
    would re-split the (B, H, P, N) state every step.  Plain tensors pass
    through."""
    dm = getattr(state, "device_mesh", None)
    if dm is None or "model" not in dm.mesh_dim_names:
        return x, Bm, Cm
    from torch.distributed.tensor import Replicate, Shard

    m = dm.mesh_dim_names.index("model")
    if not state.placements[m].is_shard(state.ndim - 1):
        return x, Bm, Cm

    def on_model(t, placement):
        pl = list(t.placements)
        pl[m] = placement
        return t.redistribute(dm, pl)

    return (on_model(x, Replicate()), on_model(Bm, Shard(Bm.ndim - 1)),
            on_model(Cm, Shard(Cm.ndim - 1)))


def _decay(p: dict, dt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw dt (..., H) -> (softplus(dt + dt_bias) in f32, log decay <= 0)."""
    dt = F.softplus(dt.float() + p["dt_bias"])
    return dt, -torch.exp(p["A_log"]) * dt


def ssd_block_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,T,d) -> (B,T,d). Training / prefill path; T is padded to a
    multiple of `cfg.ssm_chunk` inside."""
    B, T, _ = x.shape
    d_in, N, H = _dims(cfg)
    z, xs, bc, dt = _streams(cfg, p, x)
    xs = _causal_conv(xs, p["conv_w"], p["conv_b"])
    Bm, Cm = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"]).split([N, N], dim=-1)
    xs = xs.reshape(B, T, H, cfg.ssm_head_dim)
    dt, log_a = _decay(p, dt)
    x_in = xs * dt[..., None].to(xs.dtype)  # dt also scales the input
    pad_t = (-T) % cfg.ssm_chunk
    if pad_t:
        x_in = F.pad(x_in, (0, 0, 0, 0, 0, pad_t))
        log_a, Bm, Cm = (F.pad(t, (0, 0, 0, pad_t)) for t in (log_a, Bm, Cm))
    # per rank on a model mesh: its heads, B and C whole (one group)
    y = local_heads(lambda x, a, b, c: ssd_chunked(x, a, b, c, chunk=cfg.ssm_chunk)[0],
                    x_in, log_a, batch=(Bm, Cm))
    y = y[:, :T] + p["D"][:, None] * xs
    y = rms_norm(y.reshape(B, T, d_in) * silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"]


def init_ssd_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """The rolling conv histories (the last K - 1 inputs of each stream)
    and the f32 state.  No `len`: the recurrence needs no position."""
    d_in, N, H = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv - 1, 2 * N), dtype=dtype, device=device),
        "state": torch.zeros((batch, H, cfg.ssm_head_dim, N), dtype=torch.float32,
                             device=device),
    }


def ssd_block_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: dict
                     ) -> tuple[torch.Tensor, dict]:
    """x (B,1,d) against the block's cache -> (y (B,1,d), new cache), in
    constant time per token; the cache passed in is not written."""
    B = x.shape[0]
    d_in, N, H = _dims(cfg)
    z, xs, bc, dt = _streams(cfg, p, x[:, 0])
    hist = torch.cat([cache["conv"], xs[:, None, :]], dim=1)  # (B,K,d_in)
    xs_t = silu(torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"])
    hist_bc = torch.cat([cache["conv_bc"], bc[:, None, :]], dim=1)
    bc_t = silu(torch.einsum("bkc,kc->bc", hist_bc, p["conv_bc_w"]) + p["conv_bc_b"])
    Bm, Cm = bc_t.split([N, N], dim=-1)
    xs_t = xs_t.reshape(B, H, cfg.ssm_head_dim)
    dt, log_a = _decay(p, dt)
    x_in, Bm, Cm = _keep_state_split(cache["state"], xs_t * dt[..., None].to(xs_t.dtype), Bm, Cm)
    y, state = ssd_decode_step(x_in, log_a, Bm, Cm, cache["state"])
    y = (y + p["D"][:, None] * xs_t).reshape(B, 1, d_in)
    y = rms_norm(y * silu(z)[:, None, :], p["norm"], cfg.norm_eps)
    return y @ p["w_out"], {"conv": hist[:, 1:], "conv_bc": hist_bc[:, 1:], "state": state}
