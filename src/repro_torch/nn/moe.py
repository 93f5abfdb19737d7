"""Mixture-of-Experts with sort-based capacity dispatch (the reference's
nn/moe.py).

Tokens are stably argsorted by expert, packed into a static (E, C, D)
capacity buffer by gathers, pushed through batched per-expert matmuls and
gathered back through the inverse permutation. Dispatch is per batch row:
each row has its own capacity C (:func:`_capacity`), and a row's entries
beyond C for one expert are dropped, the later ones in token order, so
the dropped tokens are the reference's. The combine weights the surviving
expert outputs by the router's weights (softmax over the top-k logits, or
the sigmoid of each); shared experts run densely for every token.

The router runs in float32 from ``x`` cast to float32, as the reference
does. Everything here is plain PyTorch: the reference computes MoE in
jnp, outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.nn.layers import Leaf, dense, mlp_apply, mlp_struct, \
    shardable


BUF_AXES = ("act_batch", "experts", "moe_cap", "act_embed")


def moe_struct(leaf: Leaf, prefix: str, cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    p = {
        "router": leaf(f"{prefix}.router", (d, m.num_experts),
                       ("embed", "experts"), scale=0.02),
        # stacked expert weights: leading experts axis
        "w_gate": leaf(f"{prefix}.w_gate", (m.num_experts, d, m.d_ff_expert),
                       ("experts", "embed", "mlp")),
        "w_up": leaf(f"{prefix}.w_up", (m.num_experts, d, m.d_ff_expert),
                     ("experts", "embed", "mlp")),
        "w_down": leaf(f"{prefix}.w_down", (m.num_experts, m.d_ff_expert, d),
                       ("experts", "mlp", "embed")),
    }
    for i in range(m.n_shared_experts):
        p[f"shared_{i}"] = mlp_struct(leaf, f"{prefix}.shared_{i}", d,
                                      m.d_ff_shared, "swiglu")
    return p


def _capacity(tokens: int, m) -> int:
    """Per-row expert capacity: ceil-ish T·k·cf/E, at least 8 and a
    multiple of 8, but never above T·k (a decode row of one token)."""
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    c = max(8, -(-c // 8) * 8)
    return min(c, tokens * m.top_k)


def route(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The router: (top-k expert ids (B, S, k), their weights (B, S, k)
    float32). Ties between logits, which random float32 weights do not
    produce, may be broken otherwise than ``jax.lax.top_k`` does."""
    m = cfg.moe
    logits = dense(x.float(), p["router"].float())              # (B, S, E)
    top_vals, top_idx = torch.topk(logits, m.top_k, dim=-1)
    if m.router_softmax_topk:
        weights = torch.softmax(top_vals, dim=-1)
    else:
        weights = torch.sigmoid(top_vals)
    return top_idx, weights


@shardable
def dispatch(top_idx: torch.Tensor, cfg: ModelConfig, s: int):
    """Sort-based dispatch plan of one batch of rows. Returns (``tok``
    (B, E·C): the token each buffer slot takes, ``fill`` (B, E·C): whether
    the slot holds one, ``slot_tok`` (B, S·k): each (token, choice)'s
    buffer slot, ``keep_tok`` (B, S·k): whether it got one, C)."""
    m = cfg.moe
    b = top_idx.shape[0]
    sk = s * m.top_k
    dev = top_idx.device
    flat_e = top_idx.reshape(b, sk)
    # stable, like jnp.argsort: a group keeps its entries in token order
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    token_of = sort_idx // m.top_k
    experts = torch.arange(m.num_experts, device=dev)
    first_of_e = torch.searchsorted(
        sorted_e, experts.expand(b, -1).contiguous(), right=False)  # (B, E)
    counts = torch.diff(first_of_e, dim=-1, append=torch.full(
        (b, 1), sk, device=dev, dtype=first_of_e.dtype))
    pos_in_group = torch.arange(sk, device=dev)[None, :] - torch.gather(
        first_of_e, 1, sorted_e)
    cap = _capacity(s, m)
    keep = pos_in_group < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_group,
                       m.num_experts * cap - 1)
    # buffer slot (e, c) takes the token at sorted position first_of_e[e] + c
    ar = torch.arange(cap, device=dev)
    src_q = first_of_e[:, :, None] + ar[None, None, :]           # (B, E, C)
    fill = (ar[None, None, :] < counts[:, :, None]).reshape(b, -1)
    src_q = torch.clamp(src_q, max=sk - 1).reshape(b, -1)
    tok = torch.gather(token_of, 1, src_q)                       # (B, E·C)
    inv_sort = torch.empty_like(sort_idx)
    inv_sort.scatter_(1, sort_idx, torch.arange(sk, device=dev).expand(b, -1))
    return (tok, fill, torch.gather(slot, 1, inv_sort),
            torch.gather(keep, 1, inv_sort), cap)


@shardable
def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j]]`` for every row b: x (B, M, D), idx (B, N) ->
    (B, N, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              constrain=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). ``constrain(t, axes)`` is called on the
    (B, E, C, D) capacity buffer and on the experts' output, as in the
    reference (None: no-op)."""
    constrain = constrain or (lambda t, axes: t)
    m = cfg.moe
    b, s, d = x.shape
    top_idx, weights = route(p, x, cfg)
    tok, fill, slot_tok, keep_tok, cap = dispatch(top_idx, cfg, s)
    buf = take_rows(x, tok)                                     # (B, E·C, D)
    buf = buf * fill[..., None].to(buf.dtype)
    buf = constrain(buf.reshape(b, m.num_experts, cap, d), BUF_AXES)
    # the batched expert SwiGLU: one product per matrix over (E, B·C, D)
    xs = buf.transpose(0, 1).reshape(m.num_experts, b * cap, d)
    h = F.silu(torch.bmm(xs, p["w_gate"].to(x.dtype))) \
        * torch.bmm(xs, p["w_up"].to(x.dtype))
    out_e = torch.bmm(h, p["w_down"].to(x.dtype))               # (E, B·C, D)
    out_e = constrain(out_e.reshape(m.num_experts, b, cap, d)
                      .transpose(0, 1), BUF_AXES)
    out_flat = out_e.reshape(b, m.num_experts * cap, d)
    vals = take_rows(out_flat, slot_tok)
    vals = torch.where(keep_tok[..., None], vals, 0.0)
    y = (vals.reshape(b, s, m.top_k, d)
         * weights[..., None].to(vals.dtype)).sum(dim=2)
    y = y.to(x.dtype)
    for i in range(m.n_shared_experts):
        y = y + mlp_apply(p[f"shared_{i}"], x, "swiglu")
    return y
