"""The model's functions on DTensors, where DTensor cannot run them as
written: the port's own, with no counterpart in the reference (XLA
partitions every op of its program itself).

Each version below is registered in ``nn.layers.SHARDED`` for the model
function it stands in for (the functions marked ``@shardable``), and is
called with that function and its arguments: with no DTensor among them
it calls the function as it is, so an unsharded run is unchanged bit for
bit. ``dist/shardings.py`` imports this module, so every program that
lays tensors out by :class:`~repro_torch.dist.shardings.ShardingRules`
has them. None converts a tensor to a full one silently: each lays its
inputs out by an explicit ``redistribute`` and, where DTensor has no
sharding strategy (or a slow or gathering one), runs the function on
each rank's local shards under ``local_map``:

  ``nn.layers.dense``        leading dimensions split once (pin)
  ``nn.attention._heads``    a split into whole heads only (pin)
  ``nn.attention._merge_heads``  the gradient's layout kept (pin)
  ``nn.attention._attend``   the kernel, or decode's attention, per shard
  ``nn.moe.dispatch``        per batch row (no strategy for its sorts)
  ``nn.moe.take_rows``       per batch row (the gather's backward zeros
                             the global batch's buffer on every rank)
  ``nn.ssd._ssd_scan``       per batch row (5-d einsums: minutes of
                             layout search, then gathers)
  ``models.lm._lookup``      vocabulary-parallel (torch 2.11's ``index``
                             rejects a batch split over two mesh axes)
  ``models.lm.cross_entropy``  vocabulary-parallel (DTensor's logsumexp
                             and gather gather the vocabulary)
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import lm
from repro_torch.nn import attention, layers, moe, ssd


def _version(fn):
    """Register ``version`` for ``fn``: called with plain tensors, it
    calls ``fn`` itself."""
    def register(version):
        def call(plain, *args, **kwargs):
            if any(isinstance(a, DTensor) for a in args):
                return version(plain, *args, **kwargs)
            return plain(*args, **kwargs)

        layers.SHARDED[fn] = call
        return version

    return register


# -- layout pins --------------------------------------------------------------

@_version(layers.dense)
def _dense(plain, x, w, b=None):
    """``x``'s leading (all but the last) dimensions split on the mesh by
    the first (the batch) only; a split of any other is gathered (the
    sequence of a (batch, sequence)-sharded activation before a
    column-parallel matmul). A matmul flattens them: DTensor lays a
    flattened doubly-split dimension out as a strided shard, whose
    sizing is slow and whose first strategy choice replicates the whole
    product, and torch 2.11 cannot flatten a split of a dimension but
    the first."""
    if not isinstance(x, DTensor):   # a DTensor weight only
        return plain(x, w, b)
    inner = {p.dim for p in x.placements
             if isinstance(p, Shard) and 0 < p.dim < x.dim() - 1}
    if inner:
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim in inner else p
            for p in x.placements])
    return plain(x, w, b)


@_version(attention._heads)
def _heads(plain, x, n, dh):
    """``x`` (B, S, n * dh) with its last dimension gathered on the mesh
    dimensions that split it, unless they split it into whole heads (8
    kv heads projected on a 16-way axis: DTensor cannot unflatten
    that)."""
    split = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == x.dim() - 1]
    if n % math.prod(x.device_mesh.shape[i] for i in split):
        x = x.redistribute(x.device_mesh, [
            Replicate() if i in split else p
            for i, p in enumerate(x.placements)])
    return plain(x, n, dh)


@_version(attention._merge_heads)
def _merge_heads(plain, out):
    """The merged output redistributed to its own layout: its gradient
    then comes back in that layout before the reshape's backward
    unflattens it into heads (which a split into parts of heads
    cannot)."""
    out = plain(out)
    return out.redistribute(out.device_mesh, out.placements)


# -- attention per shard ------------------------------------------------------

def local_kv_heads(kv: torch.Tensor, q_heads: int, g: int,
                   m: int) -> torch.Tensor:
    """The kv heads that model shard ``m`` reads when q's heads are split
    ``q_heads`` a shard and k/v's (B, Hkv, S, dh) are whole. Shard ``m``
    holds global q heads [m·q_heads, (m+1)·q_heads), and global q head h
    reads kv head h // g (g = Hq / Hkv); the result is in the local GQA
    layout: local q head i reads local kv head i // (q_heads / its
    heads), contiguous (the kernel takes no strides)."""
    lo = m * q_heads
    if q_heads % g == 0:         # whole groups: their kv heads
        return kv[:, lo // g:(lo + q_heads) // g].contiguous()
    if g % q_heads == 0:         # part of one group: its kv head
        return kv[:, lo // g:lo // g + 1].contiguous()
    # groups straddle the shard: one kv head per local q head
    return kv.repeat_interleave(g, dim=1)[:, lo:lo + q_heads].contiguous()


@_version(attention._attend)
def sharded_attention(plain, op, q: DTensor, k: DTensor, v: DTensor, **kw):
    """``op(q, k, v, **kw)`` (the registry's attention, or decode's over
    the cache) on plain local tensors under ``local_map``, with no
    communication inside: the kernel takes plain tensors.

    Layout: the batch is split over every mesh axis but ``model`` when
    it divides their product, q's heads over ``model`` when they divide
    it; k and v take the same split when their heads divide ``model``
    too. Otherwise (GQA with fewer kv heads than model ranks, e.g. 8 kv
    heads on 16) k and v stay whole on ``model`` and each shard takes
    the kv heads its global q heads read (:func:`local_kv_heads`); their
    gradients are then partial sums over ``model``. The inputs are
    redistributed to this layout explicitly; the output keeps q's."""
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    b, hq = q.shape[0], q.shape[1]
    hkv = k.shape[1]
    batch_axes = [a for a in names if a != "model"]
    split_b = b % math.prod(sizes[a] for a in batch_axes) == 0
    n_model = sizes.get("model", 1)
    split_q = n_model > 1 and hq % n_model == 0
    split_kv = split_q and hkv % n_model == 0

    def layout(split_heads):
        return tuple((Shard(1) if split_heads else Replicate())
                     if a == "model" else
                     (Shard(0) if split_b else Replicate()) for a in names)

    q_pl, kv_pl = layout(split_q), layout(split_kv)
    q, k, v = (t.redistribute(mesh, pl)
               for t, pl in ((q, q_pl), (k, kv_pl), (v, kv_pl)))
    if split_q and not split_kv:
        hl, g, m = hq // n_model, hq // hkv, mesh.get_local_rank("model")
        kv_grad = tuple(Partial() if a == "model" else p
                        for a, p in zip(names, kv_pl))

        def local(q, k, v):
            return op(q, local_kv_heads(k, hl, g, m),
                      local_kv_heads(v, hl, g, m), **kw)
    else:
        kv_grad = kv_pl

        def local(q, k, v):
            return op(q, k, v, **kw)

    # a list: local_map reads a tuple as one placement per output
    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


# -- functions of whole batch rows --------------------------------------------

def row_placements(x) -> tuple:
    """A DTensor's placements with only its batch (dim 0) sharding kept:
    what a function of whole batch rows needs."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def map_rows(fn, *tensors, outs: tuple, whole: tuple = ()):
    """``fn`` on each rank's batch rows. The DTensors ``tensors`` (one
    mesh, dim 0 the batch) are redistributed explicitly to
    :func:`row_placements` of the first (whole rows on each rank: a
    gather of whatever else is sharded); the DTensors ``whole`` (weights
    without a batch dimension) are gathered whole, and their gradients
    are partial sums on the mesh dimensions that split the rows. ``fn``
    gets the local tensors, ``tensors`` then ``whole``, under
    ``local_map``. ``outs`` has one entry per output of ``fn``: True for a
    tensor whose dim 0 is the batch (it comes back a DTensor of the rows'
    placements), None for anything else."""
    mesh = tensors[0].device_mesh
    rows = row_placements(tensors[0])
    full = (Replicate(),) * mesh.ndim
    partial = tuple(Partial() if isinstance(p, Shard) else Replicate()
                    for p in rows)
    args = [t.redistribute(mesh, rows) for t in tensors] \
        + [w.redistribute(mesh, full) for w in whole]
    return local_map(fn, out_placements=tuple(rows if o else None
                                              for o in outs),
                     in_placements=(rows,) * len(tensors)
                     + (full,) * len(whole),
                     in_grad_placements=(rows,) * len(tensors)
                     + (partial,) * len(whole),
                     device_mesh=mesh)(*args)


@_version(moe.dispatch)
def _dispatch(plain, top_idx, cfg, s):
    return map_rows(lambda t: plain(t, cfg, s), top_idx,
                    outs=(True, True, True, True, None))


@_version(moe.take_rows)
def _take_rows(plain, x, idx):
    """Per batch row: DTensor's gather backward makes its zeros whole
    (a (B, E·C, D) buffer of the global batch on every rank)."""
    return map_rows(plain, x, idx, outs=(True,))


@_version(ssd._ssd_scan)
def _ssd_scan(plain, x, dt, a_log, b, c, cfg, init_state=None):
    assert init_state is None, "a sharded scan starts from zero"
    return map_rows(lambda x, dt, b, c, a_log: plain(x, dt, a_log, b, c, cfg),
                    x, dt, b, c, whole=(a_log,), outs=(True, True))


# -- the vocabulary -----------------------------------------------------------

@_version(lm._lookup)
def _lookup(plain, table, toks):
    """``table[toks]``; a table split over the mesh takes the
    vocabulary-parallel lookup per rank under ``local_map``: the table's
    vocabulary split over ``model`` when it divides (its other splits
    gathered), the tokens' batch split kept and the rest gathered; each
    rank looks up the tokens its vocabulary shard holds, zeros the
    others, and the shards' rows are summed (an all-reduce over
    ``model``). The table's gradient is a partial sum over the mesh axes
    that split the batch."""
    if not any(isinstance(p, Shard) for p in table.placements):
        return plain(table, toks)
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    n_model = dict(zip(names, mesh.shape)).get("model", 1)
    split = n_model > 1 and table.shape[0] % n_model == 0
    rows = row_placements(toks)
    vocab = Shard(0) if split else Replicate()
    t_pl = tuple(vocab if a == "model" else Replicate() for a in names)
    t_grad = tuple(vocab if a == "model" else
                   Partial() if isinstance(r, Shard) else Replicate()
                   for a, r in zip(names, rows))
    out_pl = tuple(Partial() if a == "model" and split else r
                   for a, r in zip(names, rows))
    v_local = table.shape[0] // n_model if split else table.shape[0]
    v0 = mesh.get_local_rank("model") * v_local if split else 0

    def local(t, ids):
        idx = ids.long() - v0
        hit = (idx >= 0) & (idx < v_local)
        return t[idx.clamp(0, v_local - 1)] * hit[..., None].to(t.dtype)

    out = local_map(local, out_placements=list(out_pl),
                    in_placements=(t_pl, rows),
                    in_grad_placements=(t_grad, rows), device_mesh=mesh)(
        table.redistribute(mesh, t_pl), toks.redistribute(mesh, rows))
    return out.redistribute(mesh, rows)


@_version(lm.cross_entropy)
def _cross_entropy(plain, logits, labels):
    """With the vocabulary split over ``model`` (when ``model`` divides
    V) and the batch over the other mesh axes (when it divides them):
    the row max, the sum of exponentials and the gold logit (picked by a
    mask of the local vocabulary ids) reduce across the vocabulary shards
    as partial results, so no rank holds a whole row of logits, and the
    gradient, softmax − one-hot, is formed in the logits' own layout
    (:class:`_VocabParallelCE`). DTensor's own logsumexp and gather
    gather the vocabulary first, and its gradients of the reductions
    come back split by rows, which costs a gather of the whole (B, S, V)
    gradient."""
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    if sizes.get("model", 1) == 1 or logits.shape[-1] % sizes["model"]:
        return plain(logits, labels)
    others = math.prod(n for a, n in zip(names, mesh.shape) if a != "model")
    row = Shard(0) if logits.shape[0] % others == 0 else Replicate()

    def layout(vocab):
        return tuple(vocab if a == "model" else row for a in names)

    logits = logits.redistribute(mesh, layout(Shard(logits.dim() - 1)))
    rows = layout(Replicate())
    return _VocabParallelCE.apply(logits.float(),
                                  labels.redistribute(mesh, rows), rows)


class _VocabParallelCE(torch.autograd.Function):
    """The mean cross entropy of vocabulary-split float32 DTensor logits;
    the backward is (softmax − one-hot) · mask / count, in the logits'
    layout, with no communication."""

    @staticmethod
    def forward(ctx, logits, labels, rows):
        mesh = logits.device_mesh
        m = logits.amax(dim=-1, keepdim=True).redistribute(mesh, rows)
        total = torch.exp(logits - m).sum(dim=-1).redistribute(mesh, rows)
        lse = torch.log(total) + m[..., 0]
        # the one-hot of the labels in the logits' layout, made per rank
        # (torch 2.11's broadcast of a vocabulary-split arange against
        # the labels replicates the vocabulary: a (B, S, V) mask a rank)
        v_local = logits.to_local().shape[-1]
        v0 = mesh.get_local_rank("model") * v_local

        def one_hot(lab):
            ids = torch.arange(v0, v0 + v_local, device=lab.device)
            return ids == lab.clamp(min=0)[..., None]

        hit = local_map(one_hot, out_placements=list(logits.placements),
                        in_placements=(rows,), device_mesh=mesh)(labels)
        gold = torch.where(hit, logits, 0.0).sum(dim=-1).redistribute(
            mesh, rows)
        mask = (labels >= 0).float()
        count = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(logits, lse, hit, mask, count)
        return torch.sum((lse - gold) * mask) / count

    @staticmethod
    def backward(ctx, grad):
        logits, lse, hit, mask, count = ctx.saved_tensors
        scale = (mask / count * grad)[..., None]
        return (torch.exp(logits - lse[..., None]) - hit.float()) * scale, \
            None, None
