"""The port's composition layer and request-respond channel
(repro_torch.core.compose, core/request_respond.py, routing.reply,
algorithms/common.py) against the JAX package's, which run per worker
under ``jax.vmap(axis_name=...)``. Same numpy inputs from a seed; the
port takes the W workers as the leading dim. Ids, values, overflow
flags and traffic are exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.algorithms import common as jcommon
from repro.algorithms import sv as jsv
from repro.core import compose as jcompose
from repro.core import message as jmsg
from repro.core import request_respond as jrr
from repro.core import routing as jrouting
from repro.core.channel import ChannelContext as JContext
from repro_torch.algorithms import common, sv
from repro_torch.core import compose, message as msg
from repro_torch.core import request_respond as rr
from repro_torch.core import routing
from repro_torch.core.channel import ChannelContext, key_under

AXIS = "w"
W, N_LOC = 4, 16
CPU = torch.device("cpu")


def jvmap(fn, *args):
    return jax.vmap(fn, axis_name=AXIS)(*args)


def jctx():
    return JContext(AXIS, W, N_LOC)


def ctx(**kw):
    return ChannelContext(W, N_LOC, CPU, **kw)


def t(x):
    return torch.from_numpy(np.asarray(x))


def same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def requests(seed, d=None, hot=False):
    """(dst, valid, vals): one request per local vertex, destinations over
    the whole id space (``hot``: all into 3 ids on 3 workers, so dedup
    collapses them to one wire message per owner), attribute values of
    width ``d``."""
    rng = np.random.default_rng(seed)
    if hot:
        dst = (rng.integers(0, 3, (W, N_LOC)) * N_LOC + 5).astype(np.int32)
    else:
        dst = rng.integers(0, W * N_LOC, (W, N_LOC)).astype(np.int32)
    valid = rng.random((W, N_LOC)) < 0.8
    shape = (W, N_LOC) if d is None else (W, N_LOC, d)
    vals = rng.integers(-100, 100, shape).astype(np.int32)
    return dst, valid, vals


def _stats(c, keys):
    return [c.stats_bytes[k] for k in keys] + [c.stats_msgs[k] for k in keys]


RR_KEYS = ("request_respond/request", "request_respond/respond")


@pytest.mark.parametrize("cap", [N_LOC, 2], ids=["fits", "overflows"])
@pytest.mark.parametrize("d,hot", [(None, False), (3, False), (None, True)],
                         ids=["d1", "d3", "hot"])
def test_request_matches_jax(d, hot, cap):
    dst, valid, vals = requests(1, d, hot)

    def shard(dd, v, x):
        c = jctx()
        out, ovf = jrr.request(c, dd, v, x, capacity=cap)
        return [out, ovf, c.stats_ovf["request_respond/request"]] + _stats(
            c, RR_KEYS)

    want = jvmap(shard, dst, valid, vals)
    c = ctx()
    out, ovf = rr.request(c, t(dst), t(valid), t(vals), capacity=cap)
    got = [out, ovf, c.stats_ovf["request_respond/request"]] + _stats(
        c, RR_KEYS)
    for g, w in zip(got, want):
        same(g, w)
    assert bool(ovf.any()) == (cap == 2 and not hot)


def test_request_with_no_valid_entry_charges_nothing_under_both_keys():
    dst, _, vals = requests(2)
    c = ctx()
    out, ovf = rr.request(c, t(dst), torch.zeros(W, N_LOC, dtype=torch.bool),
                          t(vals), capacity=N_LOC)
    assert not out.any() and not ovf.any()
    assert set(c.stats_bytes) == set(c.stats_msgs) == set(RR_KEYS)
    for s in _stats(c, RR_KEYS):
        assert not s.any()


@pytest.mark.parametrize("cap", [N_LOC, 3], ids=["fits", "overflows"])
def test_reply_matches_jax(cap):
    """Each requester gets the answer to its own message back, in its
    original order; dropped messages read zeros."""
    dst, valid, _ = requests(4)
    resp = np.random.default_rng(5).integers(
        -9, 9, (W, W, cap, 2)).astype(np.int32)

    def shard(dd, v, rsp):
        r = jrouting.route(jctx(), dd, v, {}, cap, use_kernel=False)
        return jrouting.reply(jctx(), r, {"v": rsp})["v"]

    want = jvmap(shard, dst, valid, resp)
    r = routing.route(ctx(), t(dst), t(valid), {}, cap)
    got = routing.reply(r, {"v": t(resp)})["v"]
    same(got, want)


@pytest.mark.parametrize("d", [None, 2])
def test_direct_request_respond_matches_jax(d):
    dst, valid, vals = requests(6, d)
    keys = ("basic_reqresp/request", "basic_reqresp/respond")

    def shard(dd, v, x):
        c = jctx()
        out, ovf = jcommon.direct_request_respond(c, dd, v, x)
        return [out, ovf] + _stats(c, keys)

    want = jvmap(shard, dst, valid, vals)
    c = ctx()
    out, ovf = common.direct_request_respond(c, t(dst), t(valid), t(vals))
    for g, w in zip([out, ovf] + _stats(c, keys), want):
        same(g, w)


def test_pj_converge_matches_jax():
    """A random forest over all W * n_loc slots, crossing workers: the
    roots, the rounds and the traffic of every round, the last unchanged
    one included."""
    rng = np.random.default_rng(7)
    n = W * N_LOC
    par = np.zeros(n, np.int64)
    par[1:] = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    perm = rng.permutation(n)
    parents = np.empty(n, np.int64)
    parents[perm] = perm[par]
    parents = parents.astype(np.int32).reshape(W, N_LOC)
    mask = np.ones((W, N_LOC), bool)

    def shard(p, m):
        c = jctx()
        roots, it = jcommon.pj_converge(c, p, m, use_reqresp=True)
        return roots, it, c.stats_bytes["pj_loop"], c.stats_msgs["pj_loop"]

    want = jvmap(shard, parents, mask)
    c = ctx()
    roots, rounds = common.pj_converge(c, t(parents), t(mask))
    same(roots, want[0])
    assert rounds == int(np.asarray(want[1])[0]) > 2
    same(c.stats_bytes["pj_loop"], want[2])
    same(c.stats_msgs["pj_loop"], want[3])


def test_stacked_channel_names_match_jax():
    port, ref = sv.composed_channels(), jsv.composed_channels()
    assert port.channel_names() == ref.channel_names() == (
        "sv/jump", "sv/merge", "sv/neighbor_min", "sv/pointer/request",
        "sv/pointer/respond")
    assert compose.channel_names_of(["a", port]) == (
        jcompose.channel_names_of(["a", ref]))
    assert compose.channel_names_of("a") == ("a",)


@pytest.mark.parametrize("select", [None, 0, 1])
def test_scoped_merges_namespaced_and_selected(select):
    """A child's stats fold back under the prefix, times the select; an
    unselected child's overflow does not latch. The child shares the
    parent's capacity scales under its composed full name."""
    parent = ctx(cap_scales={"sv/pointer/request": 4.0}, route_cap=8)
    sel = None if select is None else torch.tensor(select, dtype=torch.int32)
    with compose.scoped(parent, "sv", select=sel) as sub:
        assert sub.name_prefix == "sv" and sub.route_cap == 8
        assert sub.scale_capacity("pointer/request", 5) == 32
        assert sub.scale_capacity("merge", 5) == 5
        sub.add_traffic("merge", torch.arange(W), 1)
        sub.add_overflow("merge", torch.ones(W, dtype=torch.bool))
    keep = 1 if select is None else select
    same(parent.stats_bytes["sv/merge"], np.arange(W) * keep)
    same(parent.stats_msgs["sv/merge"], np.full(W, keep))
    same(parent.stats_ovf["sv/merge"], np.full(W, bool(keep)))


def _switch_run(port: bool, density: float, threshold):
    """Both branches send; returns (result, use_dense, stats) of one
    switch_by_density call in either package."""
    dst, valid, vals = requests(8)

    def branches(m, c_mod):
        def dense(sub):
            out, _, ovf = m.combined_send(sub, *c_mod(dst, valid, vals),
                                          "min", capacity=N_LOC, name="d")
            return out, ovf

        def sparse(sub):
            out, _, ovf = m.combined_send(sub, *c_mod(dst, valid, -vals),
                                          "max", capacity=2, name="s")
            return out, ovf
        return dense, sparse

    keys = ("wcc/dense/d", "wcc/sparse/s")
    if port:
        c = ctx()
        dense, sparse = branches(msg, lambda *a: [t(x) for x in a])
        dens = torch.full((W,), density, dtype=torch.float32)
        (out, ovf), use = compose.switch_by_density(c, "wcc", dens, threshold,
                                                    dense, sparse)
        return [out, ovf, use] + _stats(c, keys) + [c.stats_ovf[k]
                                                    for k in keys]

    def shard(_):
        c = jctx()
        dense, sparse = branches(jmsg, lambda *a: [
            jnp.asarray(x)[jax.lax.axis_index(AXIS)] for x in a])
        (out, ovf), use = jcompose.switch_by_density(
            c, "wcc", jnp.float32(density), threshold, dense, sparse)
        return [out, ovf, use] + _stats(c, keys) + [c.stats_ovf[k]
                                                    for k in keys]

    return jvmap(shard, jnp.zeros(W))


@pytest.mark.parametrize("density,threshold", [
    (0.3, None), (0.05, None), (0.1, None), (0.3, 0.5), (0.1, 0.1)],
    ids=["dense", "sparse", "at-default", "explicit-sparse", "explicit-at"])
def test_switch_by_density_matches_jax(density, threshold):
    """Both branches run; only the chosen one is charged and may latch
    its overflow (the sparse branch overflows at capacity 2)."""
    got = _switch_run(True, density, threshold)
    want = _switch_run(False, density, threshold)
    for g, w in zip(got, want):
        same(g, w)


def test_dense_threshold_knob_ladder(monkeypatch):
    monkeypatch.delenv("REPRO_DENSE_THRESHOLD", raising=False)
    assert compose.resolve_dense_threshold() == 0.1
    monkeypatch.setenv("REPRO_DENSE_THRESHOLD", "0.25")
    assert compose.resolve_dense_threshold() == 0.25
    with compose.dense_threshold_scope(0.5):
        assert compose.resolve_dense_threshold() == 0.5
        with compose.dense_threshold_scope(None):
            assert compose.resolve_dense_threshold() == 0.25
        assert compose.resolve_dense_threshold(0.75) == 0.75
    assert compose.resolve_dense_threshold() == 0.25


def test_global_fraction_is_worker_uniform():
    c = ctx()
    frac = compose.global_fraction(c, torch.tensor([1, 2, 3, 4]),
                                   torch.tensor([10, 10, 10, 10]))
    assert frac.dtype == torch.float32
    same(frac, np.full(W, 0.25, np.float32))
    empty = compose.global_fraction(c, torch.zeros(W), torch.zeros(W))
    same(empty, np.zeros(W, np.float32))


def test_stat_helpers_match_jax():
    stats = {"sv/pointer/request": 3, "sv/pointer/respond": 4, "sv/jump": 5,
             "svx": 1, "merge_message": 2}
    assert compose.group_stats(stats) == jcompose.group_stats(stats) == {
        "sv": 12, "svx": 1, "merge_message": 2}
    for prefix in ("sv", "sv/pointer", "sv/jump", "merge_message", "s"):
        assert (compose.stats_under(stats, prefix)
                == jcompose.stats_under(stats, prefix))
    assert key_under("sv/jump", "sv") and not key_under("svx", "sv")
