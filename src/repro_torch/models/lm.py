"""Decoder LM: the port of the reference's unified ``models/lm.py``.

One structure function describes every block kind the reference's
decoder has — ``attn``, ``local_attn`` (a sliding window of
``cfg.local_window``), ``rglru`` (RecurrentGemma) and ``mamba2`` (SSD) —
with a dense MLP, a MoE layer (``cfg.is_moe_layer``) or none
(``mlp_kind="none"``) after it. Configs with token inputs, one codebook
and plain RoPE run; the rest raise ``NotImplementedError`` (ROADMAP.md,
Queue 1 items 7.5–7.6). Parameters are the reference's tree — dicts and
lists with the same key names, shapes and dtypes — so they cross between
the packages through :func:`params_from_numpy`.

Entry points:
    init_params(cfg, gen)                       # on gen.device
    forward(params, cfg, batch)                 # (B,S) -> logits (B,S,V)
    prefill(params, cfg, batch, max_len)        # -> (logits, caches)
    decode_step(params, cfg, batch, caches)     # one token + caches

Prefill and forward run attention through the kernel registry
(``backend=``: ``cuda`` by default, or ``reference``). The dense
projections, MLP, MoE, recurrences, norms, RoPE, head and decode
attention are plain PyTorch, as the reference leaves them to XLA.
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
from repro_torch.nn.moe import moe_apply, moe_struct
from repro_torch.nn.rglru import (rglru_apply, rglru_cache_struct,
                                  rglru_decode, rglru_struct)
from repro_torch.nn.ssd import (ssd_cache_struct, ssd_decode,
                                ssd_prefill_cache, ssd_struct)

BLOCK_KINDS = ("attn", "local_attn", "rglru", "mamba2")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless the port runs ``cfg``."""
    missing = []
    if cfg.input_mode != "tokens":
        missing.append(f"input_mode {cfg.input_mode!r} (item 7.5)")
    if cfg.rope_kind != "rope":
        missing.append(f"rope_kind {cfg.rope_kind!r} (item 7.5)")
    if cfg.n_codebooks != 1:
        missing.append("codebooks (item 7.6)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md, "
            f"Queue 1)")
    unknown = set(cfg.pattern) - set(BLOCK_KINDS)
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(unknown)}")


# ---------------------------------------------------------------------------
# Parameter structure
# ---------------------------------------------------------------------------

def _layer_struct(leaf, i: int, cfg: ModelConfig) -> dict:
    kind = cfg.pattern[i]
    pre = f"layers.{i}"
    p: dict[str, Any] = {"ln1": leaf(f"{pre}.ln1", (cfg.d_model,), ("embed",),
                                     init="zeros")}
    if kind in ("attn", "local_attn"):
        p["attn"] = attn_struct(leaf, f"{pre}.attn", cfg)
    elif kind == "rglru":
        p["mixer"] = rglru_struct(leaf, f"{pre}.rglru", cfg)
    else:
        p["mixer"] = ssd_struct(leaf, f"{pre}.ssd", cfg)
    if cfg._layer_has_mlp(i):
        p["ln2"] = leaf(f"{pre}.ln2", (cfg.d_model,), ("embed",), init="zeros")
        if cfg.is_moe_layer(i):
            p["moe"] = moe_struct(leaf, f"{pre}.moe", cfg)
        else:
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


def uncounted_params(cfg: ModelConfig) -> int:
    """Parameters that the reference's analytic ``cfg.num_params()``
    leaves out: the conv biases of the rglru and mamba2 blocks. A
    parameter tree holds ``num_params() + uncounted_params()`` numbers."""
    total = 0
    for kind in cfg.pattern:
        if kind == "rglru":
            total += cfg.rglru.lru_width or cfg.d_model
        elif kind == "mamba2":
            total += cfg.ssm.expand * cfg.d_model \
                + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    return total


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


def _window(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.local_window if kind == "local_attn" else None


def _ffn_residual(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "ln2" not in lp:
        return x
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    ffn = moe_apply(lp["moe"], h, cfg) if "moe" in lp \
        else mlp_apply(lp["mlp"], h, cfg.mlp_kind)
    return x + cfg.residual_scale * ffn


def _prefill_layers(params, cfg: ModelConfig, batch, max_len, backend):
    """The layers over a whole sequence: (hidden states (B,S,D), per-layer
    decode caches, or None when ``max_len`` is None)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions = _positions(batch, b, s, x.device)
    caches = []
    for kind, lp in zip(cfg.pattern, params["layers"]):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if kind in ("attn", "local_attn"):
            window = _window(cfg, kind)
            mix, (k, v) = attn_apply(lp["attn"], h, cfg, positions,
                                     window=window, return_kv=True,
                                     backend=backend)
            cache = None if max_len is None \
                else attn_prefill_cache(k, v, max_len, window)
        elif kind == "rglru":
            mix, cache = rglru_apply(lp["mixer"], h, cfg, return_state=True)
        else:
            mix, cache = ssd_prefill_cache(lp["mixer"], h, cfg)
        caches.append(cache)
        x = _ffn_residual(lp, x + cfg.residual_scale * mix, cfg)
    return x, (None if max_len is None else caches)


def forward(params, cfg: ModelConfig, batch, *, backend=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B,S,V)."""
    x, _ = _prefill_layers(params, cfg, batch, None, backend)
    return _logits_out(params, cfg, x)


# ---------------------------------------------------------------------------
# Serving: prefill + decode with per-layer caches
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 device: torch.device | str | None = None) -> list:
    check_supported(cfg)
    caches = []
    for kind in cfg.pattern:
        if kind in ("attn", "local_attn"):
            caches.append(attn_cache_struct(cfg, batch, max_len,
                                            _window(cfg, kind), device))
        elif kind == "rglru":
            caches.append(rglru_cache_struct(cfg, batch, device))
        else:
            caches.append(ssd_cache_struct(cfg, batch, device))
    return caches


def prefill(params, cfg: ModelConfig, batch, max_len: int, *, backend=None):
    """Run the prompt, return (last-position logits (B,1,V), caches)."""
    x, caches = _prefill_layers(params, cfg, batch, max_len, backend)
    return _logits_out(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg: ModelConfig, batch, caches):
    """One decode step. batch: {"tokens": (B,1), "pos": int}. Updates the
    caches in place; returns (logits (B,1,V), caches)."""
    pos = int(batch["pos"])
    x = _embed_in(params, cfg, batch)
    for kind, lp, cache in zip(cfg.pattern, params["layers"], caches):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if kind in ("attn", "local_attn"):
            mix, _ = attn_decode(lp["attn"], h, cfg, cache, pos,
                                 window=_window(cfg, kind))
        elif kind == "rglru":
            mix, _ = rglru_decode(lp["mixer"], h, cfg, cache)
        else:
            mix, _ = ssd_decode(lp["mixer"], h, cfg, cache)
        x = _ffn_residual(lp, x + cfg.residual_scale * mix, cfg)
    return _logits_out(params, cfg, x), caches
