"""Mamba2 (SSD — state-space duality) block, chunked matmul formulation
(the reference's nn/ssd.py).

The sequence is split into chunks; intra-chunk work is dense products
batched over the chunk axis, and the inter-chunk first-order recurrence
over per-chunk states runs as a loop over the chunks (S / 256 of them:
the reference's ``associative_scan`` over so few elements is the same
recurrence). The whole of :func:`_ssd_scan` is float32, whatever the
compute dtype.

Shapes: d_in = expand·d_model, H heads of P = head_dim, G state groups,
N = d_state. Conv is a width-4 depthwise causal conv over (x, B, C).
Decode writes the new state into the cache dict it is given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.nn.layers import Leaf, dense, rms_norm, shardable
# the same depthwise causal conv as the RG-LRU block's
from repro_torch.nn.rglru import _causal_conv


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nheads, conv_ch


def ssd_struct(leaf: Leaf, prefix: str, cfg: ModelConfig) -> dict:
    s, d_in, nheads, conv_ch = _dims(cfg)
    d = cfg.d_model
    in_dim = 2 * d_in + 2 * s.n_groups * s.d_state + nheads
    return {
        "in_proj": leaf(f"{prefix}.in_proj", (d, in_dim), ("embed", "ssm_in")),
        "conv_w": leaf(f"{prefix}.conv_w", (s.d_conv, conv_ch),
                       ("conv_w", "ssm_conv"), scale=0.5),
        "conv_b": leaf(f"{prefix}.conv_b", (conv_ch,), ("ssm_conv",), init="zeros"),
        "A_log": leaf(f"{prefix}.A_log", (nheads,), ("ssm_heads",), init="ssm_A"),
        "D": leaf(f"{prefix}.D", (nheads,), ("ssm_heads",), init="ones"),
        "dt_bias": leaf(f"{prefix}.dt_bias", (nheads,), ("ssm_heads",),
                        init="dt_bias", scale=(s.dt_min, s.dt_max)),
        "norm": leaf(f"{prefix}.norm", (d_in,), ("ssm_inner",), init="zeros"),
        "out_proj": leaf(f"{prefix}.out_proj", (d_in, d), ("ssm_inner", "embed")),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s, d_in, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * gn],
            zxbcdt[..., 2 * d_in + 2 * gn:])


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    s, d_in, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return xbc[..., :d_in], xbc[..., d_in:d_in + gn], xbc[..., d_in + gn:]


def _heads_of_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """(..., G, N) -> (..., H, N): head h reads state group h // (H / G)."""
    g = t.shape[-2]
    if g == 1:
        return t.expand(*t.shape[:-2], h, t.shape[-1])
    return torch.repeat_interleave(t, h // g, dim=-2)


@shardable
def _ssd_scan(x, dt, a_log, b, c, cfg: ModelConfig, init_state=None):
    """Chunked SSD. x (B,L,H,P); dt (B,L,H); b/c (B,L,G,N).
    Returns y (B,L,H,P), final_state (B,H,P,N), both float32. As in the
    reference, ``init_state`` enters the state after chunk 0 (decayed by
    chunk 0's decay), not chunk 0's own outputs."""
    s = cfg.ssm
    bt, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(s.chunk_size, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    lp = l + pad
    nc = lp // q

    A = -torch.exp(a_log.float())                            # (H,) negative
    dt32 = dt.float()
    a = dt32 * A[None, None, :]                              # (B,L,H) log-decay
    xc = x.reshape(bt, nc, q, h, p).float()
    ac = a.reshape(bt, nc, q, h)
    dtc = dt32.reshape(bt, nc, q, h)
    bh = _heads_of_groups(b.reshape(bt, nc, q, g, n).float(), h)
    ch = _heads_of_groups(c.reshape(bt, nc, q, g, n).float(), h)

    cum_a = torch.cumsum(ac, dim=2)                          # (B,nc,Q,H)

    # ---- intra-chunk (dense, batched over chunks) ----
    seg = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]  # (B,nc,q,s,H)
    # mask before the exp: above the diagonal seg > 0 and exp(seg) may be
    # inf, and inf · 0 would be NaN
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    l_mat = torch.exp(seg.masked_fill(~tril[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bnqhk,bnshk->bnhqs", ch, bh)          # (B,nc,H,Q,Q)
    dt_s = dtc.permute(0, 1, 3, 2)[:, :, :, None, :]         # (B,nc,H,1,Q=s)
    m = cb * l_mat.permute(0, 1, 4, 2, 3) * dt_s             # (B,nc,H,q,s)
    y = torch.einsum("bnhqs,bnshp->bnqhp", m, xc)

    # ---- chunk states ----
    decay_out = torch.exp(cum_a[:, :, -1:, :] - cum_a)       # (B,nc,Q,H)
    su = torch.einsum("bnqhk,bnqhp->bnhpk",
                      (decay_out * dtc)[..., None] * bh, xc)

    # ---- inter-chunk recurrence, one chunk at a time ----
    chunk_decay = torch.exp(cum_a[:, :, -1, :])              # (B,nc,H)
    if init_state is not None:
        su[:, 0] += chunk_decay[:, 0, :, None, None] * init_state.float()
    states = [su[:, 0]]
    for k in range(1, nc):
        states.append(chunk_decay[:, k, :, None, None] * states[-1]
                      + su[:, k])
    # state entering chunk k = the state after chunk k - 1
    prev = torch.stack([torch.zeros_like(states[0])] + states[:-1], dim=1)

    y_inter = torch.einsum("bnqhk,bnhpk->bnqhp",
                           torch.exp(cum_a)[..., None] * ch, prev)
    y = (y + y_inter).reshape(bt, lp, h, p)[:, :l]
    return y, states[-1]


def ssd_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 mixer. x (B,S,D) -> (B,S,D)."""
    out, _ = ssd_prefill_cache(p, x, cfg)
    return out


def ssd_cache_struct(cfg: ModelConfig, batch: int,
                     device: torch.device | str | None = None) -> dict:
    s, d_in, nheads, conv_ch = _dims(cfg)
    shapes = {"state": (batch, nheads, s.head_dim, s.d_state),
              "conv": (batch, s.d_conv - 1, conv_ch)}
    return {k: torch.zeros(v, dtype=torch.float32, device=device)
            for k, v in shapes.items()}


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """y (float32, (B, L, d_in)) gated by silu(z), normed, projected."""
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["norm"], cfg.norm_eps)
    return dense(y, p["out_proj"])


def _scan_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The mixer up to its scan: (z, the pre-conv xBC (B, L, conv_ch),
    x (B, L, H, P), dt after softplus (B, L, H) float32, B and C (B, L,
    G, N))."""
    s, _, nheads, _ = _dims(cfg)
    bt, l, _ = x.shape
    z, xbc_pre, dt = _split_proj(dense(x, p["in_proj"]), cfg)
    xbc = F.silu(_causal_conv(xbc_pre, p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype)))
    xs, b, c = _split_xbc(xbc, cfg)
    dtp = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    return (z, xbc_pre, xs.reshape(bt, l, nheads, s.head_dim), dtp,
            b.reshape(bt, l, s.n_groups, s.d_state),
            c.reshape(bt, l, s.n_groups, s.d_state))


def ssd_prefill_cache(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Run the mixer over the prompt AND return (out, cache) for decode."""
    s, d_in, _, _ = _dims(cfg)
    bt, l, _ = x.shape
    z, xbc_pre, xh, dtp, bg, cg = _scan_inputs(p, x, cfg)
    y, state = _ssd_scan(xh, dtp, p["A_log"], bg, cg, cfg)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    out = _gated_out(p, y.reshape(bt, l, d_in), z, x, cfg)
    cache = {"state": state,
             "conv": xbc_pre[:, -(s.d_conv - 1):, :].float()}
    return out, cache


def ssd_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Single-token decode. x (B,1,D); cache: state (B,H,P,N), conv
    (B, d_conv-1, conv_ch). Puts the new state into ``cache`` and
    returns (out, cache)."""
    s, d_in, nheads, _ = _dims(cfg)
    bt = x.shape[0]
    z, xbc_new, dt = _split_proj(dense(x, p["in_proj"]), cfg)  # (B,1,·)
    window = torch.cat([cache["conv"].to(x.dtype), xbc_new], dim=1)
    conv_out = (window * p["conv_w"].to(x.dtype)[None]).sum(
        dim=1, keepdim=True) + p["conv_b"].to(x.dtype)[None, None]
    xs, b, c = _split_xbc(F.silu(conv_out), cfg)
    dtp = F.softplus(dt.float() + p["dt_bias"][None, None, :])[:, 0]
    xh = xs.reshape(bt, nheads, s.head_dim).float()
    bh = _heads_of_groups(b.reshape(bt, s.n_groups, s.d_state).float(),
                          nheads)                            # (B,H,N)
    ch = _heads_of_groups(c.reshape(bt, s.n_groups, s.d_state).float(),
                          nheads)
    A = -torch.exp(p["A_log"].float())
    da = torch.exp(dtp * A[None, :])                         # (B,H)
    state = cache["state"] * da[..., None, None] \
        + (dtp[..., None] * xh)[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpk,bhk->bhp", state, ch) \
        + p["D"].float()[None, :, None] * xh
    out = _gated_out(p, y.reshape(bt, 1, d_in), z, x, cfg)
    cache["state"], cache["conv"] = state, window[:, 1:, :].float()
    return out, cache
