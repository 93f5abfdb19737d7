"""Logical-axis -> mesh-axis sharding rules: the port of the reference's
``dist/shardings.py``, for DTensor on a ``DeviceMesh``.

Every parameter, activation and cache tensor carries a tuple of logical
axis names (``repro_torch.nn.layers.Axes``). :class:`ShardingRules`
turns one of those tuples plus a concrete shape into a spec — one entry
per dimension: None, a mesh-axis name, or a tuple of names — applying the
reference's three guards:

  * divisibility: a dimension is sharded only when its size divides the
    (combined) mesh-axis size; otherwise the next candidate is tried,
    then none (odd vocab sizes, 40-head models on a 16-way axis, batch 1
    long-context shapes all stay correct);
  * axis reuse: a mesh axis is used at most once per spec; the first
    dimension that claims it wins;
  * missing mesh axes: rule entries naming axes the mesh lacks are
    dropped, so one table serves ``("data", "model")`` and
    ``("pod", "data", "model")`` meshes.

A rule value is a tuple of candidates tried in order; each candidate is
one mesh-axis name or a tuple of names (sharded over the combined axis).
``()`` means never shard. A spec equals ``tuple(PartitionSpec)`` of the
reference for the same shape, axes and mesh.

:meth:`ShardingRules.sharding` maps a spec to DTensor placements, one per
mesh dimension: ``Shard(d)`` on every mesh dimension a tensor dimension
``d`` is split over (a combined entry splits major to minor in the
mesh's order, as JAX does), ``Replicate()`` on the others. The rules
take a ``DeviceMesh``, or a plain ``{axis: size}`` mapping for planning
without devices (the counterpart of JAX's ``AbstractMesh``), which gives
specs but no placements.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch

# Candidate tables: logical axis -> tuple of candidates (see the module
# docstring). Anything not listed is replicated.
DEFAULT_RULES: dict[str, tuple] = {
    # activations
    "act_batch": (("pod", "data"),),
    "act_seq": ("model",),
    "act_embed": (),
    # embeddings / output head
    "embed": ("data",),
    "embed_in": (),
    "vocab": ("model",),
    "codebooks": (),
    # attention
    "heads": ("model",),
    "kv_heads": ("model",),
    "kv_heads_n": ("model",),
    "head_dim": (),
    "cache_seq": (),
    # MLP / MoE
    "mlp": ("model",),
    "experts": (),
    "moe_cap": (),
    "ef": ("model",),
    # recurrent / SSM mixers
    "lru": ("model",),
    "lru_gate": ("model",),
    "conv_w": (),
    "ssm_in": ("model",),
    "ssm_inner": ("model",),
    "ssm_conv": ("model",),
    "ssm_heads": ("model",),
    "ssm_p": (),
    "ssm_state": (),
    # misc input axes / scan-stacked layer axis
    "mrope3": (),
    "layers": (),
}


def _normalize_rule(value) -> tuple:
    """Accept a bare axis name, a candidate tuple, or () (= unsharded)."""
    if isinstance(value, str):
        return (value,)
    return tuple(value)


def _tree_map(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a tree of dicts, lists and tuples and the
    matching tree of ``Axes``, keeping the structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, axes_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, a)
                          for v, a in zip(tree, axes_tree, strict=True))
    return fn(tree, axes_tree)


class ShardingRules:
    """A sharding-rule table bound to one mesh: a ``DeviceMesh`` or an
    ``{axis: size}`` mapping (specs only)."""

    def __init__(self, mesh, rules: dict[str, tuple] | None = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES) if rules is None else rules
        if isinstance(mesh, Mapping):
            self._axis_sizes = dict(mesh)
        else:
            self._axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def override(self, **overrides) -> "ShardingRules":
        """New rules with the given logical axes remapped (``()`` ->
        replicated, ``"model"`` / ``("pod", "data")`` / candidate tuples
        as in the table)."""
        new = dict(self.rules)
        for name, value in overrides.items():
            new[name] = _normalize_rule(value)
        return ShardingRules(self.mesh, new)

    # -- spec construction -------------------------------------------------

    def spec(self, shape, axes) -> tuple:
        """The spec of one tensor: shape + logical axis names."""
        names = tuple(axes)
        shape = tuple(shape)
        if len(names) != len(shape):
            raise ValueError(f"rank mismatch: shape {shape} vs axes {names}")
        entries: list = []
        used: set[str] = set()
        for dim, name in zip(shape, names):
            entry = None
            for cand in map(_normalize_rule, self.rules.get(name, ())):
                mesh_axes = tuple(a for a in cand if a in self._axis_sizes)
                if not mesh_axes or any(a in used for a in mesh_axes):
                    continue
                total = math.prod(self._axis_sizes[a] for a in mesh_axes)
                if total <= 1 or dim % total != 0:
                    continue
                entry = mesh_axes[0] if len(mesh_axes) == 1 else mesh_axes
                used.update(mesh_axes)
                break
            entries.append(entry)
        return tuple(entries)

    def placements(self, spec: tuple) -> tuple:
        """DTensor placements of ``spec`` on the bound ``DeviceMesh``."""
        from torch.distributed.tensor import Replicate, Shard

        if isinstance(self.mesh, Mapping):
            raise TypeError("placements need a DeviceMesh; these rules are "
                            "bound to a mapping of axis sizes")
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            for axis in (entry,) if isinstance(entry, str) else entry:
                out[names.index(axis)] = Shard(dim)
        return tuple(out)

    def sharding(self, shape, axes) -> tuple:
        """The placements of one tensor: shape + logical axis names."""
        return self.placements(self.spec(shape, axes))

    # -- tree variants -----------------------------------------------------

    def tree_specs(self, tree, axes_tree):
        """A tree of tensors (anything with ``.shape``) and its matching
        tree of ``Axes`` -> the tree of specs."""
        return _tree_map(lambda x, ax: self.spec(x.shape, ax), tree,
                         axes_tree)

    def tree_shardings(self, tree, axes_tree):
        return _tree_map(lambda x, ax: self.sharding(x.shape, ax), tree,
                         axes_tree)

    def distribute(self, tree, axes_tree):
        """The tree's tensors as DTensors laid out by the rules. Each
        rank passes the same full tensors and keeps its own shards (no
        communication): a split leaf's shard is a copy, so the full
        tensor is freed with its last reference, and a replicated leaf
        keeps its tensor's storage. A DTensor leaf is constrained
        (:meth:`constrain`)."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        def one(x, ax):
            if isinstance(x, DTensor):
                return self.constrain(x, ax)
            d = distribute_tensor(x, self.mesh, self.sharding(x.shape, ax),
                                  src_data_rank=None)
            local = d.to_local()
            if local.untyped_storage().nbytes() == \
                    local.numel() * local.element_size():
                return d
            return DTensor.from_local(local.clone(), self.mesh, d.placements,
                                      run_check=False, shape=d.shape,
                                      stride=d.stride())

        return _tree_map(one, tree, axes_tree)

    # -- activation constraint (the Constrain protocol of models/lm.py) ---

    def constrain(self, x: torch.Tensor, axes) -> torch.Tensor:
        """A DTensor redistributed to the rules' layout for ``axes``
        (itself when it has it already); a plain tensor as it is."""
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        target = self.sharding(x.shape, axes)
        if tuple(x.placements) == target:
            return x
        return x.redistribute(x.device_mesh, target)


# the model's DTensor versions: registered with the rules, so any program
# that lays tensors out by them runs the model on those tensors
from repro_torch.dist import sharded_ops  # noqa: E402,F401
