"""The benchmark's Graph500 generator, root sampler and arrivals."""
import numpy as np
import pytest
import torch

from perfbench import harness, yardstick

g500 = harness.load("generators", "graph500")
CONFIG = {"scale": 10, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19,
          "symmetric": True, "weights": "uniform01"}


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_same_seed_same_graph_and_other_seed_another():
    a, b = (g500.make(CONFIG, 2**40 + 3, torch.device("cpu"))
            for _ in range(2))
    c = g500.make(CONFIG, 2**40 + 4, torch.device("cpu"))
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert torch.equal(a.weight, b.weight)
    assert a.num_edges != c.num_edges or not torch.equal(a.src, c.src)


def test_edge_factor_and_quadrant_shares():
    scale, ef = 12, 16
    src, dst = g500.kronecker_bits(scale, ef, 0.57, 0.19, 0.19, _gen(5),
                                   "cpu")
    assert src.numel() == ef << scale
    for bit in (0, scale // 2, scale - 1):
        i, j = (src >> bit) & 1, (dst >> bit) & 1
        shares = [float(((i == a) & (j == b)).float().mean())
                  for a, b in ((0, 0), (0, 1), (1, 0), (1, 1))]
        assert shares == pytest.approx([0.57, 0.19, 0.19, 0.05], abs=0.01)


def test_relabelled_edges_keep_the_count_and_range():
    scale = 9
    src, dst = g500.kronecker(scale, 16, 0.57, 0.19, 0.19, _gen(1), "cpu")
    assert src.numel() == 16 << scale
    assert int(src.max()) < 1 << scale and int(dst.min()) >= 0


def test_symmetrised_graph_is_symmetric_simple_with_equal_weights():
    g = g500.make(CONFIG, 11, torch.device("cpu"))
    key = g.src * g.n + g.dst
    assert bool((g.src != g.dst).all())
    assert torch.equal(key, torch.unique(key))
    fwd = dict(zip(key.tolist(), g.weight.tolist()))
    for s, d, w in zip(g.src.tolist()[:500], g.dst.tolist()[:500],
                       g.weight.tolist()[:500]):
        assert fwd[d * g.n + s] == w
    assert float(g.weight.min()) >= 0 and float(g.weight.max()) < 1


def test_duplicates_keep_their_smallest_weight():
    src = torch.tensor([0, 1, 0, 2])
    dst = torch.tensor([1, 0, 1, 2])
    w = torch.tensor([0.5, 0.25, 0.75, 0.1])
    s, d, ww = g500.symmetrised(3, src, dst, w)
    assert s.tolist() == [0, 1] and d.tolist() == [1, 0]
    assert ww.tolist() == [0.25, 0.25]


def test_roots_are_distinct_vertices_of_nonzero_degree():
    g = g500.make(CONFIG, 99, torch.device("cpu"))
    deg = g.out_degree()
    roots = g500.roots(g, 64, 1234)
    assert len(set(roots)) == 64
    assert all(int(deg[r]) > 0 for r in roots)
    assert roots == g500.roots(g, 64, 1234)
    assert roots != g500.roots(g, 64, 1235)


def test_arrivals_are_seeded_and_every_order_spans_the_same_time():
    a = yardstick.poisson_arrivals(256, 25.6, 7, 1)
    assert a == yardstick.poisson_arrivals(256, 25.6, 7, 1)
    b = yardstick.poisson_arrivals(256, 25.6, 7, 2)
    assert a != b and abs(a[-1] - b[-1]) <= 1
    assert a == sorted(a)
    long = yardstick.poisson_arrivals(20000, 25.6, 3, 4)
    assert 20000 / long[-1] == pytest.approx(25.6, rel=0.03)
    with pytest.raises(ValueError):
        yardstick.poisson_arrivals(4, 0.0, 1, 1)


def test_substreams_take_seeds_past_32_bits():
    s = yardstick.substream(2**33 + 5, 2, 0)
    assert 0 <= s < 2**63
    assert s == yardstick.substream(2**33 + 5, 2, 0)
    assert s != yardstick.substream(2**33 + 5, 2, 1)
    assert s != yardstick.substream(2**33 + 6, 2, 0)
    np.random.default_rng(s)
