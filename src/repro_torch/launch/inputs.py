"""Stand-ins for every model input: the port of ``repro.launch.inputs``.

:func:`input_specs` gives meta tensors (shapes and dtypes, no memory:
the dry-run's inputs) and the logical axes of each; :func:`concrete_inputs`
gives real inputs of the same structure from the reference's numpy
draws, bit for bit.

For the VLM and audio archs the modality frontend is a stub, as in the
reference: qwen2-vl receives precomputed patch embeddings (B, S, D) plus
(3, B, S) M-RoPE position ids; musicgen receives (B, S, 4) EnCodec
codebook token ids.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.nn.layers import Axes

ACT = ("act_batch", "act_seq", "act_embed")


def token_axes(cfg: ModelConfig) -> Axes:
    """The axes of a (B, S) token or label tensor, (B, S, C) with C
    codebooks."""
    if cfg.n_codebooks > 1:
        return Axes(("act_batch", "act_seq", "codebooks"))
    return Axes(("act_batch", "act_seq"))


def batch_axes(cfg: ModelConfig, batch: dict) -> dict:
    """The logical axes of each entry of a model batch (the keys of
    :func:`input_specs`, whichever are present)."""
    named = {"embeddings": Axes(ACT), "tokens": token_axes(cfg),
             "labels": token_axes(cfg), "pos": Axes(())}
    out = {}
    for key, t in batch.items():
        if key == "positions":
            out[key] = Axes(("mrope3", "act_batch", "act_seq")[-t.dim():])
        else:
            out[key] = named[key]
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(meta tensors, axes) dicts for the given shape kind.

    train:   {tokens|embeddings[, positions], labels}
    prefill: {tokens|embeddings[, positions]}
    decode:  {tokens|embeddings, pos}   (+ caches, from
             ``lm.cache_struct(..., abstract=True)``)
    """
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    tshape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    specs: dict = {}
    if cfg.input_mode == "embeddings":
        specs["embeddings"] = meta((b, s, cfg.d_model), cfg.cdtype)
        if cfg.rope_kind == "mrope" and shape.kind != "decode":
            specs["positions"] = meta((3, b, s), torch.int32)
    else:
        specs["tokens"] = meta(tshape, torch.int32)
    if shape.kind == "train":
        specs["labels"] = meta(tshape, torch.int32)
    if shape.kind == "decode":
        specs["pos"] = meta((), torch.int32)
    return specs, batch_axes(cfg, specs)


def concrete_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                    device: torch.device | str = "cpu"):
    """Real inputs with :func:`input_specs`' structure, from the
    reference's draws: one ``default_rng(seed)`` taken in sorted key
    order (as ``jax.tree.map`` walks a dict); integers uniform in
    [0, vocab) ([0, 2^30) for the scalar ``pos``), floats standard
    normal in float64, rounded to the input dtype through float32 as
    the reference's ``jnp.asarray`` does."""
    rng = np.random.default_rng(seed)
    specs, axes = input_specs(cfg, shape)
    out = {}
    for key in sorted(specs):
        spec = specs[key]
        if spec.dtype.is_floating_point:
            a = rng.standard_normal(tuple(spec.shape)).astype(np.float32)
        else:
            hi = cfg.vocab_size if spec.dim() else 2 ** 30
            a = rng.integers(0, hi, tuple(spec.shape)).astype(np.int32)
        out[key] = torch.from_numpy(np.asarray(a)).to(device=device,
                                                      dtype=spec.dtype)
    return {k: out[k] for k in specs}, axes
