"""The port's ``core/dataflow.py`` against ``repro.core.dataflow``.

The whole module is host arithmetic, so every function must give the
reference's numbers exactly (dict-equal, types included): the §IV-B
headline comparison ``blocked_vs_conventional`` on the reference's own
test cases (tests/test_core.py) and a grid of (nodes, D, B, budget),
Table I, the traversal choice, the schedules and the traffic simulator.
"""
import itertools

import numpy as np
import pytest

from repro.core import dataflow as jdf
from repro_torch.core import dataflow as tdf

BUDGET = 24 * 2 ** 20      # the reference tests' on-chip budget


def _same(a, b):
    """Equal values of equal Python types, recursively."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("nodes,d,b", [
    (20000, 512, 64),          # tests/test_core.py: blocking beats conventional
    (20000, 100, 32),          # B does not divide D: ceil(D/B) blocks
    (20000, 128, 32),
    (20000, 96, 32),
])
def test_blocked_vs_conventional_reference_cases(nodes, d, b):
    kw = dict(num_nodes=nodes, D=d, B=b, onchip_bytes=BUDGET)
    out = tdf.blocked_vs_conventional(**kw)
    _same(out, jdf.blocked_vs_conventional(**kw))
    assert out["S_blocked"] <= out["S_conventional"]


def test_blocked_traffic_uses_ceil_block_count():
    kw = dict(num_nodes=20000, onchip_bytes=BUDGET)
    out = tdf.blocked_vs_conventional(D=100, B=32, **kw)
    out128 = tdf.blocked_vs_conventional(D=128, B=32, **kw)
    out96 = tdf.blocked_vs_conventional(D=96, B=32, **kw)
    assert out["offchip_bytes_blocked"] == out128["offchip_bytes_blocked"]
    assert out["offchip_bytes_blocked"] == pytest.approx(
        out96["offchip_bytes_blocked"] * 4 / 3)


@pytest.mark.parametrize("nodes,d,b,budget", list(itertools.product(
    (1000, 19717), (16, 500, 1433), (16, 64, 100),
    (2 ** 20, BUDGET))))
def test_blocked_vs_conventional_grid(nodes, d, b, budget):
    kw = dict(num_nodes=nodes, D=d, B=b, onchip_bytes=budget)
    _same(tdf.blocked_vs_conventional(**kw), jdf.blocked_vs_conventional(**kw))


@pytest.mark.parametrize("s,i", list(itertools.product(
    (1, 2, 5, 8, 39), (0.5, 1.0, 2.0, 4.0))))
def test_table1_and_best_order(s, i):
    _same(tdf.table1_costs(s, i), jdf.table1_costs(s, i))
    assert tdf.best_order(s, i) == jdf.best_order(s, i)
    assert tdf.best_order(s, i, read_cost=3.0) == \
        jdf.best_order(s, i, read_cost=3.0)


def test_table1_reference_case():
    c = tdf.table1_costs(S=5, I=2.0)
    assert c["dst_stationary"]["write"] == 5
    assert c["src_stationary"]["write"] == 21
    assert c["dst_stationary"]["read"] == 42.0
    assert tdf.best_order(S=8, I=1.0) == "dst_stationary"


@pytest.mark.parametrize("order", ["dst_stationary", "src_stationary"])
@pytest.mark.parametrize("serpentine", [True, False])
def test_schedule_steps(order, serpentine):
    kw = dict(S=3, D=64, B=16, order=order, serpentine=serpentine)
    steps = list(tdf.Dataflow(**kw).steps())
    assert steps == list(jdf.Dataflow(**kw).steps())
    assert len(steps) == len(set(steps)) == 4 * 9


@pytest.mark.parametrize("b", [256, 64])
@pytest.mark.parametrize("order", ["dst_stationary", "src_stationary"])
def test_simulate_traffic_reference_inputs(b, order):
    kw = dict(nodes_per_shard=64, edges_per_shard=100.0)
    got = tdf.simulate_traffic(tdf.Dataflow(S=4, D=256, B=b, order=order),
                               **kw)
    exp = jdf.simulate_traffic(jdf.Dataflow(S=4, D=256, B=b, order=order),
                               **kw)
    assert (got.offchip_read_bytes, got.offchip_write_bytes,
            got.onchip_edge_reads, got.steps, got.offchip_bytes) == \
        (exp.offchip_read_bytes, exp.offchip_write_bytes,
         exp.onchip_edge_reads, exp.steps, exp.offchip_bytes)


@pytest.mark.parametrize("order", ["dst_stationary", "src_stationary"])
@pytest.mark.parametrize("skip_empty", [True, False])
def test_simulate_traffic_sparse_occupancy(order, skip_empty):
    occ = np.random.default_rng(0).integers(0, 3, (6, 6)) * 17.0
    df_kw = dict(S=6, D=100, B=32, order=order)
    kw = dict(nodes_per_shard=50, edges_per_shard=occ, skip_empty=skip_empty)
    got = tdf.simulate_traffic(tdf.Dataflow(**df_kw), **kw)
    exp = jdf.simulate_traffic(jdf.Dataflow(**df_kw), **kw)
    assert vars(got) == vars(exp)
