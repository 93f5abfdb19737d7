"""Decoder LM for the dense attention architectures (qwen3-8b, qwen2.5-3b).

The port of the reference's unified ``models/lm.py`` for configs whose
every block is ``attn`` with a dense MLP, token inputs and one codebook;
any other config raises ``NotImplementedError`` (ROADMAP.md, Queue 1
item 7). Parameters are the reference's tree — dicts and lists with the
same key names, shapes and dtypes — so they cross between the packages
through :func:`params_from_numpy`.

Entry points:
    init_params(cfg, gen)                       # on gen.device
    forward(params, cfg, batch)                 # (B,S) -> logits (B,S,V)
    prefill(params, cfg, batch, max_len)        # -> (logits, caches)
    decode_step(params, cfg, batch, caches)     # one token + caches

Prefill and forward run attention through the kernel registry
(``backend=``: ``cuda`` by default, or ``reference``). The dense
projections, MLP, norms, RoPE, head and decode attention are plain
PyTorch, as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.nn.attention import (attn_apply, attn_cache_struct,
                                      attn_decode, attn_prefill_cache,
                                      attn_struct)
from repro_torch.nn.layers import init_leaf, mlp_apply, mlp_struct, rms_norm


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless the port runs ``cfg``."""
    missing = []
    if set(cfg.pattern) != {"attn"}:
        missing.append(f"block kinds {sorted(set(cfg.pattern) - {'attn'})}")
    if cfg.moe is not None:
        missing.append("MoE layers")
    if cfg.input_mode != "tokens":
        missing.append(f"input_mode {cfg.input_mode!r}")
    if cfg.n_codebooks != 1:
        missing.append("codebooks")
    if cfg.rope_kind != "rope":
        missing.append(f"rope_kind {cfg.rope_kind!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md, "
            f"Queue 1 item 7)")


# ---------------------------------------------------------------------------
# Parameter structure
# ---------------------------------------------------------------------------

def _layer_struct(leaf, i: int, cfg: ModelConfig) -> dict:
    pre = f"layers.{i}"
    p: dict[str, Any] = {"ln1": leaf(f"{pre}.ln1", (cfg.d_model,), ("embed",),
                                     init="zeros")}
    p["attn"] = attn_struct(leaf, f"{pre}.attn", cfg)
    if cfg._layer_has_mlp(i):
        p["ln2"] = leaf(f"{pre}.ln2", (cfg.d_model,), ("embed",), init="zeros")
        p["mlp"] = mlp_struct(leaf, f"{pre}.mlp", cfg.d_model, cfg.d_ff,
                              cfg.mlp_kind)
    return p


def param_struct(cfg: ModelConfig, leaf) -> dict:
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    p: dict[str, Any] = {
        "embed": leaf("embed", (v, d), ("vocab", "embed"), init="embed")}
    p["layers"] = [_layer_struct(leaf, i, cfg) for i in range(cfg.n_layers)]
    p["final_norm"] = leaf("final_norm", (d,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        p["lm_head"] = leaf("lm_head", (d, v), ("embed", "vocab"))
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters in ``cfg.pdtype``, drawn from ``gen`` on its own
    device (a generator on the card builds a full-width model there,
    with no host copy)."""
    return param_struct(cfg, init_leaf(gen, cfg.pdtype))


def _to_tensor(leaf, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16: torch can't read it
        bits = torch.from_numpy(np.array(a).view(np.uint16))   # a copy
        return bits.view(torch.bfloat16).to(device)
    # copy: the source may be a read-only view (a JAX array's buffer)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, device: torch.device | str):
    """Turn a parameter tree of arrays (numpy — bfloat16 ones included —
    anything ``np.asarray`` accepts, or tensors) into tensors on
    ``device``, keeping the dict/list structure and each leaf's dtype
    bit for bit."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _to_tensor(tree, device)


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def _embed_in(params, cfg: ModelConfig, batch) -> torch.Tensor:
    x = params["embed"][batch["tokens"]]
    return x.to(cfg.cdtype) * cfg.emb_scale


def _logits_out(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].to(x.dtype).T)
    else:
        logits = torch.matmul(x, params["lm_head"].to(x.dtype))
    return logits * cfg.logit_scale


def _positions(batch, b: int, s: int, device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _mlp_residual(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "ln2" not in lp:
        return x
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + cfg.residual_scale * mlp_apply(lp["mlp"], h, cfg.mlp_kind)


def forward(params, cfg: ModelConfig, batch, *, backend=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B,S,V)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions = _positions(batch, b, s, x.device)
    for lp in params["layers"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + cfg.residual_scale * attn_apply(lp["attn"], h, cfg, positions,
                                                backend=backend)
        x = _mlp_residual(lp, x, cfg)
    return _logits_out(params, cfg, x)


# ---------------------------------------------------------------------------
# Serving: prefill + decode with per-layer caches
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 device: torch.device | str | None = None) -> list:
    check_supported(cfg)
    return [attn_cache_struct(cfg, batch, max_len, None, device)
            for _ in range(cfg.n_layers)]


def prefill(params, cfg: ModelConfig, batch, max_len: int, *, backend=None):
    """Run the prompt, return (last-position logits (B,1,V), caches)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions = _positions(batch, b, s, x.device)
    caches = []
    for lp in params["layers"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        mix, (k, v) = attn_apply(lp["attn"], h, cfg, positions,
                                 return_kv=True, backend=backend)
        caches.append(attn_prefill_cache(k, v, max_len, None))
        x = x + cfg.residual_scale * mix
        x = _mlp_residual(lp, x, cfg)
    return _logits_out(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg: ModelConfig, batch, caches):
    """One decode step. batch: {"tokens": (B,1), "pos": int}. Updates the
    caches in place; returns (logits (B,1,V), caches)."""
    pos = int(batch["pos"])
    x = _embed_in(params, cfg, batch)
    for lp, cache in zip(params["layers"], caches):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        mix, _ = attn_decode(lp["attn"], h, cfg, cache, pos)
        x = x + cfg.residual_scale * mix
        x = _mlp_residual(lp, x, cfg)
    return _logits_out(params, cfg, x), caches
