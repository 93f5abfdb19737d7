"""The port's abstract trees, inputs and ``constrain`` hook against the
reference's.

* ``abstract_params``, ``param_axes``, ``scanned_abstract_params``,
  ``cache_struct(abstract=True)`` / ``cache_axes`` and
  ``abstract_train_state`` / ``train_state_axes`` give the reference's
  tree structure, shapes, dtypes and logical axes for all ten archs at
  full size, as meta tensors.
* ``input_specs`` matches for every shape, and ``concrete_inputs`` is bit
  for bit the reference's (floats rounded to bfloat16 through float32,
  as ``jnp.asarray`` does) at smoke sizes.
* A recording ``constrain`` sees the reference's sequence of (shape,
  logical axes) in ``forward``, ``loss_fn``, ``prefill`` and
  ``decode_step`` for a dense, a MoE, an RG-LRU, an SSD, a VLM and a
  codebook smoke config; the default no-op leaves the results as they
  were.

JAX and the reference package are imported inside fixtures only.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as t_configs
from repro_torch.launch import inputs as t_inputs
from repro_torch.models import lm as t_lm
from repro_torch.nn.layers import Axes
from repro_torch.training import train_loop as t_train

from test_torch_shardings import port_paths

KINDS = {"dense": "qwen2.5-3b", "moe": "qwen2-moe-a2.7b",
         "rglru": "recurrentgemma-2b", "ssd": "mamba2-1.3b",
         "vlm": "qwen2-vl-2b", "codebooks": "musicgen-large"}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.launch import inputs
    from repro.models import lm
    from repro.nn.layers import Axes as JAxes
    from repro.training import train_loop
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=registry,
                                 inputs=inputs, lm=lm, Axes=JAxes,
                                 train_loop=train_loop)


def ref_paths(jx, tree) -> dict:
    """path -> leaf of a reference tree (``Axes`` and ShapeDtypeStructs
    are leaves)."""
    flat, _ = jx.jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jx.Axes))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _same(jx, jtree, jaxes, ttree, taxes):
    want, want_ax = ref_paths(jx, jtree), ref_paths(jx, jaxes)
    got, got_ax = port_paths(ttree), port_paths(taxes)
    assert set(got) == set(want) == set(got_ax) == set(want_ax)
    for path, leaf in want.items():
        t = got[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(leaf.shape), path
        assert str(t.dtype) == f"torch.{np.dtype(leaf.dtype).name}", path
        assert isinstance(got_ax[path], Axes)
        assert got_ax[path].names == want_ax[path].names, path
    return len(want)


@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_abstract_trees_match_reference(jx, arch):
    jcfg, tcfg = jx.registry.get_config(arch), t_configs.get_config(arch)
    n = _same(jx, jx.lm.abstract_params(jcfg), jx.lm.param_axes(jcfg),
              t_lm.abstract_params(tcfg), t_lm.param_axes(tcfg))
    # every parameter, at full size, with no memory behind it
    assert n == len(port_paths(t_lm.param_axes(tcfg)))
    _same(jx, *jx.lm.scanned_abstract_params(jcfg),
          *t_lm.scanned_abstract_params(tcfg))
    (jp, jo), (tp, to) = (jx.train_loop.abstract_train_state(jcfg),
                          t_train.abstract_train_state(tcfg))
    _same(jx, (jp, jo), jx.train_loop.train_state_axes(jcfg),
          (tp, to), t_train.train_state_axes(tcfg))
    for name in ("decode_32k", "long_500k"):
        shape = t_configs.SHAPES[name]
        _same(jx, jx.lm.cache_struct(jcfg, shape.global_batch,
                                     shape.seq_len, abstract=True),
              jx.lm.cache_axes(jcfg),
              t_lm.cache_struct(tcfg, shape.global_batch, shape.seq_len,
                                abstract=True), t_lm.cache_axes(tcfg))
    for name in t_configs.SHAPES:
        _same(jx, *jx.inputs.input_specs(jcfg, jx.registry.SHAPES[name]),
              *t_inputs.input_specs(tcfg, t_configs.SHAPES[name]))


def _small(registry, name):
    """A smoke-size shape of the kind of ``name``."""
    return dataclasses.replace(registry.SHAPES[name], seq_len=24,
                               global_batch=3)


@pytest.mark.parametrize("shape", sorted(t_configs.SHAPES))
@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_concrete_inputs_bitwise(jx, arch, shape):
    jcfg, tcfg = jx.registry.get_smoke(arch), t_configs.get_smoke(arch)
    # the model dtype bfloat16, so float inputs take the rounding route
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    want, jaxes = jx.inputs.concrete_inputs(jcfg, _small(jx.registry, shape),
                                            seed=7)
    got, taxes = t_inputs.concrete_inputs(tcfg, _small(t_configs, shape),
                                          seed=7)
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert str(g.dtype) == f"torch.{w.dtype.name}", k
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(np.int16)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        assert taxes[k].names == jaxes[k].names


def test_bf16_rounding_route_matches_reference(jx):
    """A float64 draw within float32's rounding of a bfloat16 tie rounds
    as float32 does first (twice-rounded), as the reference's
    ``jnp.asarray(x, bfloat16)`` does."""
    x = np.array([1 + 2 ** -8 + 2 ** -30, -(1 + 2 ** -8 + 2 ** -30)])
    want = np.asarray(jx.jnp.asarray(x, jx.jnp.bfloat16)).view(np.int16)
    got = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)
    assert torch.from_numpy(x).to(torch.bfloat16).view(
        torch.int16).numpy().tolist() == want.tolist()


def _recorder(log: list, to_np):
    def constrain(x, axes):
        log.append((tuple(to_np(x).shape), tuple(axes)))
        return x
    return constrain


def _batch(cfg, rng, b=2, s=8):
    tshape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    toks = rng.integers(0, cfg.vocab_size, tshape).astype(np.int32)
    batch = {"labels": toks}
    if cfg.input_mode == "embeddings":
        batch["embeddings"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = toks
    return batch


def _decode_batch(cfg, rng, b=2):
    batch = _batch(cfg, rng, b, 1)
    del batch["labels"]
    return batch


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_constrain_call_order_matches_reference(jx, kind):
    arch = KINDS[kind]
    jcfg, tcfg = jx.registry.get_smoke(arch), t_configs.get_smoke(arch)
    p = jx.jax.tree_util.tree_map(
        np.asarray, jx.lm.init_params(jcfg, jx.jax.random.key(0)))
    jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, p)
    tp = t_lm.params_from_numpy(p, "cpu")
    batch = _batch(jcfg, np.random.default_rng(1))
    dec = _decode_batch(jcfg, np.random.default_rng(2))
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jd = {k: jx.jnp.asarray(v) for k, v in dec.items()}
    td = {k: torch.from_numpy(v) for k, v in dec.items()}
    jlog, tlog = [], []
    jc, tc = _recorder(jlog, np.asarray), _recorder(tlog, lambda x: x)

    def both(name, jfn, tfn):
        jlog.clear()
        tlog.clear()
        jout, tout = jfn(jc), tfn(tc)
        assert tlog == jlog, name
        assert tlog, name
        return jout, tout

    both("forward", lambda c: jx.lm.forward(jp, jcfg, jb, constrain=c),
         lambda c: t_lm.forward(tp, tcfg, tb, constrain=c))
    both("loss_fn", lambda c: jx.lm.loss_fn(jp, jcfg, jb, constrain=c),
         lambda c: t_lm.loss_fn(tp, tcfg, tb, constrain=c))
    (_, jcache), (_, tcache) = both(
        "prefill",
        lambda c: jx.lm.prefill(jp, jcfg, jb, 12, constrain=c),
        lambda c: t_lm.prefill(tp, tcfg, tb, 12, constrain=c))
    both("decode_step",
         lambda c: jx.lm.decode_step(jp, jcfg, dict(jd, pos=jx.jnp.int32(8)),
                                     jcache, constrain=c),
         lambda c: t_lm.decode_step(tp, tcfg, dict(td, pos=8), tcache,
                                    constrain=c))


def test_default_constrain_changes_nothing():
    """The no-op default and an explicit identity give the same bits."""
    cfg = t_configs.get_smoke("qwen2-moe-a2.7b")
    params = t_lm.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, np.random.default_rng(3)).items()}
    a = t_lm.loss_fn(params, cfg, batch)
    b = t_lm.loss_fn(params, cfg, batch, constrain=lambda x, axes: x)
    assert torch.equal(a, b)
