"""The port's channels (repro_torch.core) against the JAX package's,
which run per worker under ``jax.vmap(axis_name=...)`` as
tests/test_channels.py drives them. Same numpy inputs; the port takes
the W workers as the leading dim. Exact for ids, masks, slots, counts,
overflow flags, traffic and lattice/integer values; float sums at the
stated tolerance. The overflowing capacities exercise the dump rows that
stand in for JAX's dropped out-of-range scatters.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import aggregator as jagg
from repro.core import message as jmsg
from repro.core import routing as jrouting
from repro.core import scatter_combine as jsc
from repro.core.channel import ChannelContext as JContext
from repro.graph import generators as jgen
from repro.graph import pgraph as jpgraph
from repro_torch.core import aggregator as agg
from repro_torch.core import compose, message as msg, routing
from repro_torch.core import scatter_combine as sc
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import pgraph
from test_torch_graph import jax_tables

AXIS = "w"
W, N_LOC, M = 4, 16, 24
CPU = torch.device("cpu")


def jvmap(fn, *args):
    return jax.vmap(fn, axis_name=AXIS)(*args)


def jctx():
    return JContext(AXIS, W, N_LOC)


def ctx():
    return ChannelContext(W, N_LOC, CPU)


def messages(seed, dtype=np.float32, d=None):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, W * N_LOC, (W, M)).astype(np.int32)
    valid = rng.random((W, M)) < 0.8
    shape = (W, M) if d is None else (W, M, d)
    if dtype == np.int32:
        vals = rng.integers(-50, 50, shape).astype(np.int32)
    else:
        vals = rng.normal(size=shape).astype(np.float32)
    return dst, valid, vals


def t(x):
    return torch.from_numpy(np.asarray(x))


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap", [M, 3], ids=["fits", "overflows"])
@pytest.mark.parametrize("impl", ["bucket", "sort"])
def test_route_matches_jax(impl, cap):
    dst, valid, a = messages(1)
    b = np.random.default_rng(2).integers(0, 9, (W, M, 2)).astype(np.int32)

    def shard(d, v, a_, b_):
        r = jrouting.route(jctx(), d, v, {"a": a_, "b": b_}, cap, impl=impl,
                           use_kernel=False)
        return (r.ids, r.mask, r.payload["a"], r.payload["b"], r.slot,
                r.sent_count, r.overflow)

    want = jvmap(shard, dst, valid, a, b)
    r = routing.route(ctx(), t(dst), t(valid), {"a": t(a), "b": t(b)}, cap,
                      impl=impl)
    got = (r.ids, r.mask, r.payload["a"], r.payload["b"], r.slot,
           r.sent_count, r.overflow)
    for g, w in zip(got, want):
        same(g, w)
    assert bool(r.overflow.any()) == (cap == 3)


def test_route_refuses_an_unknown_impl():
    dst, valid, a = messages(1)
    with pytest.raises(ValueError, match="route impl"):
        routing.route(ctx(), t(dst), t(valid), {"a": t(a)}, M, impl="argsort")


def test_dedup_dense_matches_jax():
    dst, valid, _ = messages(3)
    want = jvmap(lambda d, v: jrouting.dedup_dense(d, v, W * N_LOC),
                 dst, valid)
    got = routing.dedup_dense(t(dst), t(valid), W * N_LOC)
    same(got[0], want[0])
    # pos is only defined where an id occurs
    occurs = np.zeros((W, W * N_LOC), bool)
    for w in range(W):
        occurs[w, dst[w][valid[w]]] = True
    np.testing.assert_array_equal(got[1].numpy()[occurs],
                                  np.asarray(want[1])[occurs])


@pytest.mark.parametrize("cap", [N_LOC, 2], ids=["fits", "overflows"])
@pytest.mark.parametrize("comb,dtype", [("min", np.int32), ("max", np.float32),
                                        ("sum", np.int32), ("sum", np.float32)])
def test_combined_send_matches_jax(comb, dtype, cap):
    dst, valid, vals = messages(4, dtype)

    def shard(d, v, x):
        c = jctx()
        out, got, ovf = jmsg.combined_send(c, d, v, x, comb, capacity=cap)
        return (out, got, ovf, c.stats_bytes["combined_message"],
                c.stats_msgs["combined_message"])

    want = jvmap(shard, dst, valid, vals)
    c = ctx()
    out, got, ovf = msg.combined_send(c, t(dst), t(valid), t(vals), comb,
                                      capacity=cap)
    if comb == "sum" and dtype == np.float32:
        # sums of a few normals in another order
        np.testing.assert_allclose(out.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
    else:
        same(out, want[0])
    same(got, want[1])
    same(ovf, want[2])
    same(c.stats_bytes["combined_message"], want[3])
    same(c.stats_msgs["combined_message"], want[4])
    assert bool(ovf.any()) == (cap == 2)


def test_direct_send_matches_jax():
    dst, valid, vals = messages(5, d=3)

    def shard(d, v, x):
        c = jctx()
        dv = jmsg.direct_send(c, d, v, {"x": x}, M)
        return (dv.dst_local, dv.payload["x"], dv.mask,
                c.stats_bytes["direct_message"])

    want = jvmap(shard, dst, valid, vals)
    c = ctx()
    dv = msg.direct_send(c, t(dst), t(valid), {"x": t(vals)}, M)
    for g, w in zip((dv.dst_local, dv.payload["x"], dv.mask,
                     c.stats_bytes["direct_message"]), want):
        same(g, w)


@pytest.mark.parametrize("cap,pad_width", [(M, 12), (M, 0), (2, 20)],
                         ids=["fits", "no-pad", "overflows"])
def test_monolithic_send_matches_jax(cap, pad_width):
    """The Pregel-monolithic baseline: delivery, bytes (4 + pad_width a
    remote message), messages and the overflow latch, as the JAX
    function gives them."""
    dst, valid, vals = messages(9, d=2)

    def shard(d, v, x):
        c = jctx()
        dv = jmsg.monolithic_send(c, d, v, {"x": x}, cap,
                                  pad_width=pad_width)
        return (dv.dst_local, dv.payload["x"], dv.mask, dv.overflow,
                c.stats_bytes["pregel_message"],
                c.stats_msgs["pregel_message"],
                c.stats_ovf["pregel_message"])

    want = jvmap(shard, dst, valid, vals)
    c = ctx()
    dv = msg.monolithic_send(c, t(dst), t(valid), {"x": t(vals)}, cap,
                             pad_width=pad_width)
    got = (dv.dst_local, dv.payload["x"], dv.mask, dv.overflow,
           c.stats_bytes["pregel_message"], c.stats_msgs["pregel_message"],
           c.stats_ovf["pregel_message"])
    for g, w in zip(got, want):
        same(g, w)
    assert bool(dv.overflow.any()) == (cap == 2)
    np.testing.assert_array_equal(
        c.stats_bytes["pregel_message"].numpy(),
        (4 + pad_width) * c.stats_msgs["pregel_message"].numpy())


@pytest.mark.parametrize("mirror", [None, 12], ids=["plain", "mirrored"])
@pytest.mark.parametrize("comb", ["sum", "min", "max"])
def test_broadcast_combine_matches_jax(comb, mirror):
    """The JAX reference path (use_kernel=False) on the identical plan."""
    g = jgen.rmat(8, edge_factor=6, seed=3)
    jpg = jpgraph.partition_graph(g, W, "random", build=("scatter_out",),
                                  mirror_threshold=mirror)
    assert (jpg.scatter_out.hub_cap > 0) == (mirror is not None)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    vals = np.random.default_rng(6).random((W, pg.n_loc)).astype(np.float32)

    def shard(plan, x):
        c = jctx()
        c.n_loc = jpg.n_loc
        out = jsc.broadcast_combine(c, plan, x, comb, use_kernel=False)
        return (out, c.stats_bytes["scatter_combine"],
                c.stats_msgs["scatter_combine"])

    want = jvmap(shard, jpg.scatter_out, vals)
    c = ChannelContext(W, pg.n_loc, CPU)
    out = sc.broadcast_combine(c, pg.scatter_out, t(vals), comb)
    if comb == "sum":
        # in-degree sums of U[0, 1) values in another order
        np.testing.assert_allclose(out.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
    else:
        same(out, want[0])
    same(c.stats_bytes["scatter_combine"], want[1])
    same(c.stats_msgs["scatter_combine"], want[2])


def test_fused_exchange_of_two_parts_equals_separate_runs():
    g = jgen.rmat(8, edge_factor=6, seed=3)
    pg = pgraph.partition_graph(g, W, build=("scatter_out", "scatter_in"),
                                device="cpu")
    vals = torch.rand(W, pg.n_loc, generator=torch.Generator().manual_seed(0))
    c = ChannelContext(W, pg.n_loc, CPU)
    parts = [sc.plan_broadcast_combine(c, pg.scatter_out, vals, "min",
                                       name="a"),
             sc.plan_broadcast_combine(c, pg.scatter_in, vals, "max",
                                       name="b")]
    fused = compose.fused_exchange(c, parts)
    solo = ChannelContext(W, pg.n_loc, CPU)
    want = [sc.broadcast_combine(solo, pg.scatter_out, vals, "min", name="a"),
            sc.broadcast_combine(solo, pg.scatter_in, vals, "max", name="b")]
    for f, w in zip(fused, want):
        assert torch.equal(f, w)
    for k in ("a", "b"):
        assert torch.equal(c.stats_bytes[k], solo.stats_bytes[k])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("comb", ["sum", "min", "max"])
def test_aggregate_matches_jax(comb, masked):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(W, N_LOC)).astype(np.float32)
    valid = rng.random((W, N_LOC)) < 0.5

    def shard(x_, v):
        c = jctx()
        out = jagg.aggregate(c, x_, comb, v if masked else None)
        return out, c.stats_bytes["aggregator"], c.stats_msgs["aggregator"]

    want = jvmap(shard, x, valid)
    c = ctx()
    out = agg.aggregate(c, t(x), comb, t(valid) if masked else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), rtol=1e-6)
    same(c.stats_bytes["aggregator"], want[1])
    same(c.stats_msgs["aggregator"], want[2])


def test_all_halted_matches_jax():
    for votes in ([True] * W, [True, False] + [True] * (W - 2)):
        want = jvmap(lambda h: jagg.all_halted(jctx(), h), jnp.asarray(votes))
        assert bool(agg.all_halted(ctx(), torch.tensor(votes))) == bool(
            np.asarray(want)[0])
    assert bool(agg.all_halted(ctx(), True))
