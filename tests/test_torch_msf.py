"""The rest of the paper's table on the port: ``pagerank:basic`` and
``msf:channels``/``monolithic`` through ``Engine.run`` against the JAX
package's ``Engine(mode="host")`` on the identical plan, and the helpers
they brought — ``direct_request_respond(tags=..., wire_width=...)``,
``pj_converge(use_reqresp=False)`` and the ``min_by_first``
CombinedMessage — against the JAX functions under ``jax.vmap``.

Supersteps, halt flags, per-channel bytes/msgs, MSF labels and edge
counts are exact; float outputs (ranks, the forest weight) within rtol
1e-5: float32 sums in another order (ROADMAP fault 4).
"""
import numpy as np
import pytest
import torch

import jax

from repro import algorithms as jalgorithms
from repro.algorithms import common as jcommon
from repro.algorithms import msf as jmsf
from repro.core import message as jmsg
from repro.core.channel import ChannelContext as JContext
from repro.graph import pgraph as jpgraph
from repro.pregel.engine import Engine as JEngine
from repro_torch.algorithms import REGISTRY, common, msf
from repro_torch.core import message as msg
from repro_torch.core.channel import ChannelContext
from repro_torch.graph import pgraph
from repro_torch.pregel.engine import Engine
from test_torch_graph import jax_tables

KEYS = ["pagerank:basic", "msf:channels", "msf:monolithic"]
SETTINGS = [(4, 7), (8, 8)]
AXIS = "w"
W, N_LOC = 4, 16


def _graphs(key, w, scale):
    spec = REGISTRY[key]
    g = spec.make_graph(scale, 0)
    jpg = jpgraph.partition_graph(g, w, "random", build=spec.build)
    return spec, g, jpg, pgraph.from_arrays(*jax_tables(jpg), device="cpu")


@pytest.mark.parametrize("w,scale", SETTINGS)
@pytest.mark.parametrize("key", KEYS)
def test_program_matches_jax_engine(key, w, scale):
    spec, g, jpg, pg = _graphs(key, w, scale)
    knobs = {"iters": 12} if key.startswith("pagerank") else {}
    want = JEngine(mode="host").run(
        jalgorithms.get_program(key, **knobs), jpg)
    got = Engine(mode="host", device="cpu").run(spec.factory(**knobs), pg)

    assert (got.steps, got.halted) == (want.steps, want.halted)
    assert got.bytes_by_channel == want.bytes_by_channel
    assert got.msgs_by_channel == want.msgs_by_channel
    if key.startswith("msf"):
        np.testing.assert_array_equal(got.output["labels"],
                                      want.output["labels"])
        assert got.output["edges"] == want.output["edges"]
        np.testing.assert_allclose(got.output["weight"],
                                   want.output["weight"], rtol=1e-5)
    else:
        np.testing.assert_allclose(got.output, want.output, rtol=1e-5,
                                   atol=1e-9)
    spec.check(g, pg, got, {})


@pytest.mark.parametrize("w,scale", SETTINGS)
def test_msf_variants_agree(w, scale):
    """The typed and the monolithic Boruvka find the same forest, the
    typed one with fewer bytes in as many supersteps."""
    _, _, _, pg = _graphs("msf:channels", w, scale)
    eng = Engine(mode="host", device="cpu")
    typed = eng.run(msf.program("channels"), pg)
    mono = eng.run(msf.program("monolithic"), pg)
    np.testing.assert_array_equal(typed.output["labels"],
                                  mono.output["labels"])
    assert typed.output["edges"] == mono.output["edges"]
    assert typed.output["weight"] == mono.output["weight"]
    assert typed.steps == mono.steps
    assert typed.total_bytes < mono.total_bytes


def test_typed_channels_match_jax():
    assert msf.typed_channels().channel_names() == (
        jmsf.typed_channels().channel_names())
    assert msf.program("monolithic").channels is None
    with pytest.raises(ValueError):
        msf.program("basic")


def jvmap(fn, *args):
    return jax.vmap(fn, axis_name=AXIS)(*args)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _stats(c, keys):
    return [c.stats_bytes[k] for k in keys] + [c.stats_msgs[k] for k in keys]


@pytest.mark.parametrize("wire_width", [None, 16])
@pytest.mark.parametrize("r,cap", [(40, 40), (40, 3)],
                         ids=["fits", "overflows"])
def test_tagged_direct_request_respond_matches_jax(r, cap, wire_width):
    """One request per edge slot (R != n_loc), the slot riding both wires
    as the tag; replies, overflow and padded traffic exact."""
    rng = np.random.default_rng(r + cap)
    dst = rng.integers(0, W * N_LOC, (W, r)).astype(np.int32)
    valid = rng.random((W, r)) < 0.7
    vals = rng.integers(-50, 50, (W, N_LOC)).astype(np.int32)
    tags = np.arange(r, dtype=np.int32)
    keys = ("q/request", "q/respond")

    def shard(dd, v, x):
        c = JContext(AXIS, W, N_LOC)
        c.cap_scales = {"*": cap / r}
        out, ovf = jcommon.direct_request_respond(
            c, dd, v, x, name="q", wire_width=wire_width, tags=tags)
        return [out, ovf] + _stats(c, keys)

    want = jvmap(shard, dst, valid, vals)
    c = ChannelContext(W, N_LOC, "cpu", cap_scales={"*": cap / r})
    out, ovf = common.direct_request_respond(
        c, _t(dst), _t(valid), _t(vals), name="q", wire_width=wire_width,
        tags=_t(tags))
    for g, w in zip([out, ovf] + _stats(c, keys), want):
        _same(g, w)
    assert bool(np.asarray(want[1]).any()) == (cap < r)


def test_direct_request_respond_without_tags_takes_one_a_vertex():
    c = ChannelContext(W, N_LOC, "cpu")
    dst = torch.zeros(W, N_LOC + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="per local vertex"):
        common.direct_request_respond(c, dst, dst > 0,
                                      torch.zeros(W, N_LOC))


@pytest.mark.parametrize("wire_width", [None, 16])
def test_pj_converge_over_direct_messages_matches_jax(wire_width):
    """A random forest crossing workers, jumped over the DirectMessage
    baseline: roots, rounds and every round's padded traffic exact."""
    rng = np.random.default_rng(11)
    n = W * N_LOC
    par = np.zeros(n, np.int64)
    par[1:] = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    perm = rng.permutation(n)
    parents = np.empty(n, np.int64)
    parents[perm] = perm[par]
    parents = parents.astype(np.int32).reshape(W, N_LOC)
    mask = rng.random((W, N_LOC)) < 0.9

    def shard(p, m):
        c = JContext(AXIS, W, N_LOC)
        roots, it = jcommon.pj_converge(c, p, m, use_reqresp=False,
                                        wire_width=wire_width)
        return roots, it, c.stats_bytes["pj_loop"], c.stats_msgs["pj_loop"]

    want = jvmap(shard, parents, mask)
    c = ChannelContext(W, N_LOC, "cpu")
    roots, rounds = common.pj_converge(c, _t(parents), _t(mask),
                                       use_reqresp=False,
                                       wire_width=wire_width)
    _same(roots, want[0])
    assert rounds == int(np.asarray(want[1])[0]) > 2
    _same(c.stats_bytes["pj_loop"], want[2])
    _same(c.stats_msgs["pj_loop"], want[3])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_min_by_first_combined_send_matches_jax(dtype):
    """Boruvka's candidate message: 4-tuples with tied keys from many
    senders a destination, combined on both sides of the wire."""
    rng = np.random.default_rng(3)
    m = 60
    dst = rng.integers(0, W * N_LOC // 2, (W, m)).astype(np.int32)
    valid = rng.random((W, m)) < 0.8
    vals = rng.integers(-9, 9, (W, m, 4)).astype(dtype)
    vals[..., 0] = rng.integers(0, 3, (W, m))

    def shard(dd, v, x):
        c = JContext(AXIS, W, N_LOC)
        out, got, ovf = jmsg.combined_send(c, dd, v, x, "min_by_first",
                                           capacity=N_LOC, wire_width=16)
        return [out, got, ovf] + _stats(c, ("combined_message",))

    want = jvmap(shard, dst, valid, vals)
    c = ChannelContext(W, N_LOC, "cpu")
    out, got, ovf = msg.combined_send(c, _t(dst), _t(valid), _t(vals),
                                      "min_by_first", capacity=N_LOC,
                                      wire_width=16)
    for g, w in zip([out, got, ovf] + _stats(c, ("combined_message",)),
                    want):
        _same(g, w)
