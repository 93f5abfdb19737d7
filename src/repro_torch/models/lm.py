"""Decoder LM: the port of the reference's unified ``models/lm.py``.

One structure function describes every architecture of the reference's
fleet — dense, MoE, VLM (embedding inputs and M-RoPE), audio (summed
codebook embeddings and parallel heads), hybrid and SSM — through the
config's per-layer block pattern: ``attn``, ``local_attn`` (a sliding
window of ``cfg.local_window``), ``rglru`` (RecurrentGemma) and
``mamba2`` (SSD), each followed by a dense MLP, a MoE layer
(``cfg.is_moe_layer``) or none (``mlp_kind="none"``). Parameters are the
reference's tree — dicts and lists with the same key names, shapes and
dtypes — so they cross between the packages through
:func:`params_from_numpy`.

Entry points:
    init_params(cfg, gen)                       # on gen.device
    abstract_params / param_axes / cache_axes   # meta tensors, Axes trees
    scanned_abstract_params(cfg)                # the stacked variant's
    forward(params, cfg, batch)                 # -> logits (B,S,V) [or (B,S,C,V)]
    loss_fn(params, cfg, batch)                 # next-token CE
    forward_scanned / loss_fn_scanned           # over stacked layers
    prefill(params, cfg, batch, max_len)        # -> (logits, caches)
    decode_step(params, cfg, batch, caches)     # one token + caches

A batch holds ``tokens`` (B, S) — (B, S, C) for C codebooks — or, for
``input_mode="embeddings"``, ``embeddings`` (B, S, D) from the (stubbed)
modality frontend; optionally ``positions`` ((B, S), or (3, B, S) for
M-RoPE) and, for the losses, ``labels`` shaped like the tokens (−100
ignored).

Forward, the losses and prefill run attention through the kernel
registry (``backend=``: ``cuda`` by default, or ``reference``); on
``cuda`` its backward is autograd of the plain version, as the
reference's. The dense projections, MLP, MoE, recurrences, norms, RoPE,
head and decode attention are plain PyTorch, as the reference leaves
them to XLA.

Every entry point takes ``constrain(x, axes)``, called on the activations
at the reference's places, with its logical axes and in its order; the
default returns ``x``. Sharded runs pass ``ShardingRules.constrain``
(``dist/shardings.py``), which lays a DTensor out by the rules.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.nn.attention import (attn_apply, attn_cache_struct,
                                      attn_decode, attn_prefill_cache,
                                      attn_struct)
from repro_torch.nn.layers import (Axes, abstract_leaf, axes_leaf, dense,
                                   init_leaf, mlp_apply, mlp_struct, rms_norm,
                                   shardable)
from repro_torch.nn.moe import moe_apply, moe_struct
from repro_torch.nn.rglru import (rglru_apply, rglru_cache_struct,
                                  rglru_decode, rglru_struct)
from repro_torch.nn.ssd import (ssd_apply, ssd_cache_struct, ssd_decode,
                                ssd_prefill_cache, ssd_struct)

Constrain = Callable[[torch.Tensor, tuple], torch.Tensor]
ACT = ("act_batch", "act_seq", "act_embed")   # the residual stream's axes


def _noop_constrain(x, axes):
    return x


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
    elif kind == "mamba2":
        p["mixer"] = ssd_struct(leaf, f"{pre}.ssd", cfg)
    else:
        raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if cfg._layer_has_mlp(i):
        p["ln2"] = leaf(f"{pre}.ln2", (cfg.d_model,), ("embed",), init="zeros")
        if cfg.is_moe_layer(i):
            p["moe"] = moe_struct(leaf, f"{pre}.moe", cfg)
        else:
            p["mlp"] = mlp_struct(leaf, f"{pre}.mlp", cfg.d_model, cfg.d_ff,
                                  cfg.mlp_kind)
    return p


def param_struct(cfg: ModelConfig, leaf) -> dict:
    d, v, c = cfg.d_model, cfg.vocab_size, cfg.n_codebooks
    p: dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        if c == 1:
            p["embed"] = leaf("embed", (v, d), ("vocab", "embed"),
                              init="embed")
        else:
            p["embed"] = leaf("embed", (c, v, d),
                              ("codebooks", "vocab", "embed"), init="embed")
    else:   # embeddings supplied by the (stubbed) modality frontend
        p["embed_proj"] = leaf("embed_proj", (d, d), ("embed_in", "embed"))
    p["layers"] = [_layer_struct(leaf, i, cfg) for i in range(cfg.n_layers)]
    p["final_norm"] = leaf("final_norm", (d,), ("embed",), init="zeros")
    if not cfg.tie_embeddings or cfg.input_mode != "tokens":
        if c == 1:
            p["lm_head"] = leaf("lm_head", (d, v), ("embed", "vocab"))
        else:
            p["lm_head"] = leaf("lm_head", (c, d, v),
                                ("codebooks", "embed", "vocab"))
    return p


def uncounted_params(cfg: ModelConfig) -> int:
    """What a parameter tree holds beyond the reference's analytic
    ``cfg.num_params()``: the conv biases of the rglru and mamba2 blocks,
    which it leaves out, and for embedding inputs the (d, d)
    ``embed_proj`` less the (V, d) embedding it counts (negative then). A
    parameter tree holds ``num_params() + uncounted_params()`` numbers."""
    total = 0
    for kind in cfg.pattern:
        if kind == "rglru":
            total += cfg.rglru.lru_width or cfg.d_model
        elif kind == "mamba2":
            total += cfg.ssm.expand * cfg.d_model \
                + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    if cfg.input_mode != "tokens":
        total += cfg.d_model * cfg.d_model \
            - cfg.vocab_size * cfg.d_model * cfg.n_codebooks
        if cfg.tie_embeddings:   # the head is there all the same
            total += cfg.vocab_size * cfg.d_model * cfg.n_codebooks
    return total


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters in ``cfg.pdtype``, drawn from ``gen`` on its own
    device (a generator on the card builds a full-width model there,
    with no host copy)."""
    return param_struct(cfg, init_leaf(gen, cfg.pdtype))


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors (shapes and dtypes only)."""
    return param_struct(cfg, abstract_leaf(cfg.pdtype))


def param_axes(cfg: ModelConfig) -> dict:
    """The parameter tree's logical axes (:class:`Axes` leaves)."""
    return param_struct(cfg, axes_leaf())


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
    if cfg.input_mode == "embeddings":
        # no emb_scale here: the reference returns the projection as is
        return dense(batch["embeddings"].to(cfg.cdtype), params["embed_proj"])
    toks = batch["tokens"]
    if cfg.n_codebooks == 1:
        x = _lookup(params["embed"], toks)
    else:   # MusicGen: the codebooks' embeddings summed in order, toks (B,S,C)
        x = sum(_lookup(params["embed"][c], toks[..., c])
                for c in range(cfg.n_codebooks))
    return x.to(cfg.cdtype) * cfg.emb_scale


@shardable
def _lookup(table: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """``table[toks]``: rows of a (V, D) embedding."""
    return table[toks]


def _logits_out(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        emb = params["embed"].to(x.dtype)
        if cfg.n_codebooks == 1:
            logits = dense(x, emb.T)
        else:
            logits = torch.einsum("bsd,cvd->bscv", x, emb)
    else:
        head = params["lm_head"].to(x.dtype)
        if cfg.n_codebooks == 1:
            logits = dense(x, head)
        else:
            logits = torch.einsum("bsd,cdv->bscv", x, head)
    return logits * cfg.logit_scale


def _positions(cfg: ModelConfig, batch, b: int, s: int,
               device) -> torch.Tensor:
    """``batch["positions"]``, else 0..S-1 for every row: (B, S), or
    (3, B, S) with equal rows for M-RoPE."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    if cfg.rope_kind == "mrope":
        return pos.expand(3, b, s)
    return pos


def _window(cfg: ModelConfig, kind: str) -> int | None:
    return cfg.local_window if kind == "local_attn" else None


def _ffn_residual(lp, x: torch.Tensor, cfg: ModelConfig,
                  constrain: Constrain, each: bool = False) -> torch.Tensor:
    """``x`` plus the layer's FFN (``x`` itself without one). ``each``
    constrains the FFN's output and the sum, as the reference's forward
    does; its prefill and decode constrain once after the layer."""
    if "ln2" not in lp:
        return x
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    ffn = moe_apply(lp["moe"], h, cfg, constrain) if "moe" in lp \
        else mlp_apply(lp["mlp"], h, cfg.mlp_kind)
    if each:
        ffn = constrain(ffn, ACT)
    x = x + cfg.residual_scale * ffn
    return constrain(x, ACT) if each else x


def _layer(lp, x: torch.Tensor, cfg: ModelConfig, kind: str, positions,
           backend, max_len: int | None = None,
           constrain: Constrain = _noop_constrain):
    """One layer over a whole sequence: (its output (B,S,D), its decode
    cache, or None when ``max_len`` is None). Without ``max_len`` it
    constrains as the reference's forward layer does (the block's output
    before the residual add, then each sum), with it as its prefill."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    cache = None
    if kind in ("attn", "local_attn"):
        window = _window(cfg, kind)
        mix, (k, v) = attn_apply(lp["attn"], h, cfg, positions,
                                 window=window, return_kv=True,
                                 backend=backend)
        if max_len is not None:
            cache = attn_prefill_cache(k, v, max_len, window)
    elif kind == "rglru":
        if max_len is None:
            mix = rglru_apply(lp["mixer"], h, cfg)
        else:
            mix, cache = rglru_apply(lp["mixer"], h, cfg, return_state=True)
    elif max_len is None:
        mix = ssd_apply(lp["mixer"], h, cfg)
    else:
        mix, cache = ssd_prefill_cache(lp["mixer"], h, cfg)
    if max_len is None:
        mix = constrain(mix, ACT)
        x = constrain(x + cfg.residual_scale * mix, ACT)
        return _ffn_residual(lp, x, cfg, constrain, each=True), None
    x = _ffn_residual(lp, x + cfg.residual_scale * mix, cfg, constrain)
    return constrain(x, ACT), cache


def _layer_apply(lp, x: torch.Tensor, cfg: ModelConfig, i: int, positions,
                 backend, constrain: Constrain = _noop_constrain
                 ) -> torch.Tensor:
    """Layer ``i`` (its kind ``cfg.pattern[i]``) over a whole sequence."""
    return _layer(lp, x, cfg, cfg.pattern[i], positions, backend,
                  constrain=constrain)[0]


def _inputs(params, cfg: ModelConfig, batch, constrain: Constrain):
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    x = constrain(x, ACT)
    return x, _positions(cfg, batch, b, s, x.device)


def forward(params, cfg: ModelConfig, batch, *,
            constrain: Constrain = _noop_constrain, remat: bool = False,
            backend=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B,S,V) [or (B,S,C,V)]. ``remat``
    recomputes each layer's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping them."""
    x, positions = _inputs(params, cfg, batch, constrain)
    for i, lp in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_layer_apply, lp, x, cfg, i, positions, backend,
                           constrain, use_reentrant=False)
        else:
            x = _layer_apply(lp, x, cfg, i, positions, backend, constrain)
    return _logits_out(params, cfg, x)


@shardable
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross entropy over ``labels >= 0`` (−100 is
    ignored), in float32: logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch, *,
            constrain: Constrain = _noop_constrain, remat: bool = False,
            backend=None) -> torch.Tensor:
    """Next-token cross entropy. labels: (B,S) or (B,S,C); −100 ignored."""
    logits = forward(params, cfg, batch, constrain=constrain, remat=remat,
                     backend=backend)
    return cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Scanned (stacked-layer) variant: the counterpart of the reference's
# lax.scan over layers grouped by their position in the block pattern
# ---------------------------------------------------------------------------

def pattern_period(cfg: ModelConfig) -> int:
    pat = cfg.pattern
    for p in (1, 2, 3, 4, 6):
        if len(pat) >= p and all(pat[i] == pat[i % p] for i in range(len(pat))):
            return p
    return len(pat)


def _map(fn, tree):
    """``fn`` over the leaves of a layer tree (nested dicts)."""
    if isinstance(tree, dict):
        return {key: _map(fn, v) for key, v in tree.items()}
    return fn(tree)


def _slice(tree, k: int):
    """Group ``k`` of a stacked layer tree: every leaf's slice [k]."""
    return _map(lambda t: t[k], tree)


def stacked_abstract_layers(cfg: ModelConfig):
    """Returns (stacked_params, stacked_axes, trail_params, trail_axes)
    as meta tensors and :class:`Axes`: the layers grouped by their
    position j < p in the block pattern (p = :func:`pattern_period`),
    each group's nf = n_layers // p layers stacked on a leading
    ``layers`` axis, and the n_layers % p trailing layers unstacked."""
    p = pattern_period(cfg)
    nf = cfg.n_layers // p
    a_leaf, x_leaf = abstract_leaf(cfg.pdtype), axes_leaf()
    abs_layers = [_layer_struct(a_leaf, i, cfg) for i in range(cfg.n_layers)]
    ax_layers = [_layer_struct(x_leaf, i, cfg) for i in range(cfg.n_layers)]
    stacked = tuple(_map(lambda t: torch.empty((nf,) + tuple(t.shape),
                                               dtype=t.dtype, device="meta"),
                         abs_layers[j]) for j in range(p))
    stacked_ax = tuple(_map(lambda ax: Axes(("layers",) + ax.names),
                            ax_layers[j]) for j in range(p))
    return stacked, stacked_ax, abs_layers[nf * p:], ax_layers[nf * p:]


def scanned_abstract_params(cfg: ModelConfig):
    """(abstract params, axes) of the scanned variant: the embedding and
    head leaves of :func:`param_struct`, ``"stack"`` and ``"trail"``
    (see :func:`forward_scanned`)."""
    full = abstract_params(cfg)
    full_ax = param_axes(cfg)
    stack, stack_ax, trail, trail_ax = stacked_abstract_layers(cfg)
    params = {k: v for k, v in full.items() if k != "layers"}
    axes = {k: v for k, v in full_ax.items() if k != "layers"}
    params["stack"], params["trail"] = stack, list(trail)
    axes["stack"], axes["trail"] = stack_ax, list(trail_ax)
    return params, axes


def forward_scanned(params, cfg: ModelConfig, batch, *,
                    constrain: Constrain = _noop_constrain,
                    remat: bool = False, backend=None) -> torch.Tensor:
    """Forward over stacked layers. ``params``: the embedding and head
    leaves of :func:`param_struct`, ``"stack"`` — a tuple of p layer
    trees (p = :func:`pattern_period`) whose leaves carry a leading axis
    of nf = n_layers // p groups — and ``"trail"``, a list of the
    n_layers % p trailing layer trees. Group k applies layers j + k·p
    (j < p) from slice k of each stacked leaf; ``remat`` recomputes a
    group's activations in the backward, as the reference's
    ``jax.checkpoint`` of its scan body."""
    p = pattern_period(cfg)
    x, positions = _inputs(params, cfg, batch, constrain)

    def group(x, k):
        for j in range(p):
            x = _layer_apply(_slice(params["stack"][j], k), x, cfg, j,
                             positions, backend, constrain)
        return x

    nf = cfg.n_layers // p
    for k in range(nf):
        x = checkpoint(group, x, k, use_reentrant=False) if remat \
            else group(x, k)
    for t, lp in enumerate(params["trail"]):
        x = _layer_apply(lp, x, cfg, nf * p + t, positions, backend,
                         constrain)
    return _logits_out(params, cfg, x)


def loss_fn_scanned(params, cfg: ModelConfig, batch, *,
                    constrain: Constrain = _noop_constrain,
                    remat: bool = False, backend=None) -> torch.Tensor:
    logits = forward_scanned(params, cfg, batch, constrain=constrain,
                             remat=remat, backend=backend)
    return cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: prefill + decode with per-layer caches
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 device: torch.device | str | None = None, *,
                 abstract: bool = False) -> list:
    """Zero decode caches on ``device``; meta tensors with ``abstract``."""
    if abstract:
        device = "meta"
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


def cache_axes(cfg: ModelConfig) -> list:
    """The logical axes of :func:`cache_struct`'s tree."""
    axes = []
    for kind in cfg.pattern:
        if kind in ("attn", "local_attn"):
            a = Axes(("act_batch", "kv_heads_n", "cache_seq", "head_dim"))
            axes.append({"k": a, "v": a})
        elif kind == "rglru":
            axes.append({"h": Axes(("act_batch", "lru")),
                         "conv": Axes(("act_batch", "conv_w", "lru"))})
        else:
            axes.append({"state": Axes(("act_batch", "ssm_heads", "ssm_p",
                                        "ssm_state")),
                         "conv": Axes(("act_batch", "conv_w", "ssm_conv"))})
    return axes


def prefill(params, cfg: ModelConfig, batch, max_len: int, *,
            constrain: Constrain = _noop_constrain, backend=None):
    """Run the prompt, return (last-position logits (B,1,V) [or
    (B,1,C,V)], caches)."""
    x, positions = _inputs(params, cfg, batch, constrain)
    caches = []
    for kind, lp in zip(cfg.pattern, params["layers"]):
        x, cache = _layer(lp, x, cfg, kind, positions, backend, max_len,
                          constrain)
        caches.append(cache)
    return _logits_out(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg: ModelConfig, batch, caches, *,
                constrain: Constrain = _noop_constrain):
    """One decode step. batch: {"tokens": (B,1) or (B,1,C) |
    "embeddings": (B,1,D), "pos": int}. M-RoPE rotates the token by
    ``pos`` in all three rows, as the reference does. Updates the caches
    in place; returns (logits (B,1,V) [or (B,1,C,V)], caches)."""
    pos = int(batch["pos"])
    x = constrain(_embed_in(params, cfg, batch), ACT)
    for kind, lp, cache in zip(cfg.pattern, params["layers"], caches):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if kind in ("attn", "local_attn"):
            mix, _ = attn_decode(lp["attn"], h, cfg, cache, pos,
                                 window=_window(cfg, kind))
        elif kind == "rglru":
            mix, _ = rglru_decode(lp["mixer"], h, cfg, cache)
        else:
            mix, _ = ssd_decode(lp["mixer"], h, cfg, cache)
        x = constrain(_ffn_residual(lp, x + cfg.residual_scale * mix, cfg,
                                    constrain), ACT)
    return _logits_out(params, cfg, x), caches
