"""The port's channel planner (``repro_torch.plan``) against the JAX
package's (``repro.plan``), case for case with ``tests/test_planner.py``,
plus what the port adds.

- Corpus-only plans (``calibrate=False``) of all 21 registry programs at
  scale 8, W=4, and of the five batched ones at Q=16, equal the JAX
  plans for the same partitioned graph: knobs, each decision's chosen
  value and source, predicted costs (rel 1e-12) and the fingerprint's
  ``cache_key()``. Plans round-trip through JSON across the packages.
- A planned run equals the hand-set run with the plan's knobs, and the
  JAX planned run, in every mode (outputs, steps, halts, bytes, msgs).
- The port's rules: a probe decides only with a ``PROBE_MARGIN``-fold
  lead, else the corpus fit does; on a ``"cuda"`` fingerprint
  ``use_kernel`` is True, ``route_impl`` is ``"bucket"`` and
  ``dense_threshold`` the default, and probes run only to explain.
  ``use_kernel`` and ``route_impl`` are Plan fields, not engine knobs:
  the port has one path per device.
- The port's probe cache is its own: it never reads a JAX
  ``.repro_plan_cache`` file whose key collides.

Every test gets fresh probe caches (both packages') under ``tmp_path``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.algorithms import REGISTRY as JREGISTRY
from repro.graph import pgraph as jpgraph
from repro.plan import Plan as JPlan, Planner as JPlanner
from repro.plan import cost_model as jcm
from repro.pregel.engine import Engine as JEngine
from repro_torch.algorithms import BATCHED, REGISTRY
from repro_torch.core import compose, routing
from repro_torch.graph import pgraph
from repro_torch.kernels import ops
from repro_torch.plan import Plan, Planner, cost_model as cm, manual_plan
from repro_torch.plan import features, planner as planning
from repro_torch.pregel.engine import Engine
from test_torch_graph import jax_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _plan_cache(tmp_path, monkeypatch):
    """Fresh probe caches for both packages; nothing written into the
    checkout."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "torch"))
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "jax"))


def _problem(key="sssp:basic", scale=8, workers=4):
    """(spec, graph, JAX graph, port graph with the identical plans,
    program inputs)."""
    spec = REGISTRY[key]
    g = spec.make_graph(scale, 0)
    jpg = jpgraph.partition_graph(g, workers, "random", build=spec.build)
    pg = pgraph.from_arrays(*jax_tables(jpg), device="cpu")
    return spec, g, jpg, pg, spec.inputs(g, 0)


def _prog(key="sssp:basic", **kw):
    spec, g, jpg, pg, inputs = _problem(key, **kw)
    return pg, spec.factory(**inputs)


# -- the knobs the planner decides ---------------------------------------


def test_dense_threshold_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_DENSE_THRESHOLD", raising=False)
    assert compose.resolve_dense_threshold() == 0.1
    monkeypatch.setenv("REPRO_DENSE_THRESHOLD", "0.25")
    assert compose.resolve_dense_threshold() == 0.25
    with compose.dense_threshold_scope(0.4):
        assert compose.resolve_dense_threshold() == 0.4
        # explicit beats the scope, which beats the env
        assert compose.resolve_dense_threshold(0.05) == 0.05
    assert compose.resolve_dense_threshold() == 0.25


def test_use_kernel_and_route_impl_are_the_ports_one_path():
    """Neither is an engine knob: a manual plan records the kernels and
    the bucket route (the port's one path; their plain versions on the
    CPU), whatever the JAX package's environment variables say."""
    for name in ("use_kernel", "route_impl"):
        with pytest.raises(TypeError):
            Engine(device="cpu", **{name: None})
    pg, prog = _prog()
    plan = Engine(device="cpu").resolve_plan(prog, pg)
    assert (plan.use_kernel, plan.route_impl) == (True, "bucket")
    for knob in ("use_kernel", "route_impl"):
        assert plan.decision(knob).source == "default"
    # on a CPU tensor either use_kernel value names the plain path
    keys = torch.tensor([[0, 2, 1, 0, 3]], dtype=torch.int32)
    want = ops.bucket_ranks(keys, 3, use_kernel=False)
    for use_kernel in (None, True):
        got = ops.bucket_ranks(keys, 3, use_kernel=use_kernel)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_card_refuses_a_plain_given_plan(monkeypatch):
    """An Engine on the card raises at construction on a given Plan with
    ``use_kernel=False`` or ``route_impl="sort"``; the card's values and
    every CPU plan construct."""
    from repro_torch.pregel import engine as engine_mod

    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="use_kernel=False"):
        Engine(plan=Plan(use_kernel=False))
    with pytest.raises(ValueError, match="route_impl='sort'"):
        Engine(plan=Plan(route_impl="sort"))
    assert Engine(plan=Plan()).device.type == "cuda"
    monkeypatch.undo()
    for given in (Plan(use_kernel=False), Plan(route_impl="sort")):
        assert Engine(device="cpu", plan=given).plan_policy is given


# -- Plan objects --------------------------------------------------------


def test_manual_plan_records_explicit_sources():
    plan = manual_plan(mode="chunked", chunk_size=8, dense_threshold=0.05,
                       explicit={"mode": "chunked", "chunk_size": 8,
                                 "dense_threshold": 0.05})
    assert plan.source == "manual"
    assert plan.key() == ("chunked", 8, True, "bucket", "union", 0.05)
    assert plan.decision("dense_threshold").source == "explicit"
    assert plan.decision("use_kernel").source == "default"


def test_plan_json_round_trip_auto():
    pg, prog = _prog()
    plan = Planner(calibrate=False).plan(prog, pg)
    assert plan.source == "auto" and plan.fingerprint is not None
    rt = Plan.from_json(json.dumps(plan.to_json()))
    assert rt.knobs() == plan.knobs()
    assert rt.key() == plan.key()
    assert rt.fingerprint == plan.fingerprint
    assert [d.knob for d in rt.decisions] == [d.knob for d in plan.decisions]
    assert rt.decision("route_impl").source == \
        plan.decision("route_impl").source


def test_runresult_plan_stamped_and_round_trips():
    pg, prog = _prog()
    res = Engine(device="cpu").run(prog, pg)
    assert res.plan is not None and res.plan.source == "manual"
    rt = Plan.from_json(json.dumps(res.plan.to_json()))
    assert rt.knobs() == res.plan.knobs()
    assert res.dense_threshold == res.plan.dense_threshold


def test_planner_explain_lists_every_knob():
    pg, prog = _prog()
    text = Planner(calibrate=False).plan(prog, pg).explain()
    for knob in planning.KNOBS:
        assert knob in text


# -- Engine plan policies ------------------------------------------------


def test_engine_rejects_unknown_plan():
    with pytest.raises(ValueError, match="unknown plan"):
        Engine(device="cpu", plan="always")


def test_explicit_knob_wins_under_auto():
    pg, prog = _prog()
    eng = Engine(device="cpu", plan="auto", dense_threshold=0.3)
    plan = eng.resolve_plan(prog, pg)
    assert plan.dense_threshold == 0.3
    assert plan.decision("dense_threshold").source == "explicit"
    # the un-set knobs are still the planner's
    assert plan.decision("use_kernel").source == "planner"


def test_given_plan_is_used_and_explicit_still_wins():
    given = Plan(mode="chunked", chunk_size=8, route_impl="sort",
                 dense_threshold=0.2)
    pg, prog = _prog()
    assert Engine(device="cpu", plan=given).resolve_plan(
        prog, pg).key() == given.key()
    over = Engine(device="cpu", plan=given,
                  dense_threshold=0.05).resolve_plan(prog, pg)
    assert over.dense_threshold == 0.05 and over.mode == "chunked"
    assert over.route_impl == "sort"
    res = Engine(device="cpu", plan=given).run(prog, pg)
    assert res.plan is given and res.mode == "chunked"
    assert res.dispatches == -(-res.steps // 8)


def test_auto_plan_memoized_per_fingerprint():
    pg, prog = _prog()
    eng = Engine(device="cpu", plan="auto")
    assert eng.resolve_plan(prog, pg) is eng.resolve_plan(prog, pg)


def test_planner_does_not_touch_engine_cache_or_stats():
    pg, prog = _prog()
    eng = Engine(device="cpu", plan="auto")
    before = ops.launch_counts()
    eng.resolve_plan(prog, pg)  # runs the calibration probes
    assert eng.stats() == {"compiles": 0, "cache_hits": 0,
                           "cached_executables": 0, "runs": 0}
    assert ops.launch_counts() == before


def test_planned_and_hand_set_runs_share_one_executable():
    """A planner choice and the identical hand-set choice key the same
    loop: the second planned run is a hit, and an engine given the plan's
    knobs as a Plan builds its loop under the same key."""
    pg, prog = _prog()
    eng = Engine(device="cpu", plan="auto")
    r1 = eng.run(prog, pg)
    r2 = eng.run(prog, pg)
    assert r1.plan.key() == r2.plan.key()
    assert eng.compiles == 1 and eng.cache_hits == 1
    plan = r1.plan
    hand = Engine(device="cpu", plan=Plan(**plan.knobs()))
    hand.run(prog, pg)
    assert set(hand._cache) == set(eng._cache)


# -- bit-identity: planned == hand-set == the JAX planned run -------------


def _same_but_route_impl(jax_plan, plan):
    """Calibrated plans of the two packages agree but for ``route_impl``:
    each follows its own probes, and on the CPU at scale 8 the port's
    measure the sort baseline ahead of the plain bucket ranks by more
    than PROBE_MARGIN (corpus-only plans agree on every knob)."""
    want = dict(jax_plan.knobs(), route_impl=plan.route_impl)
    assert want == plan.knobs()


def _assert_bit_identical(key, mode):
    spec, g, jpg, pg, inputs = _problem(key)
    prog = spec.factory(**inputs)
    auto = Engine(device="cpu", plan="auto", mode=mode, chunk_size=3)
    res_a = auto.run(prog, pg)
    plan = res_a.plan
    assert plan.source == "auto"
    hand = Engine(device="cpu", mode=mode, chunk_size=plan.chunk_size,
                  route_batch=plan.route_batch,
                  dense_threshold=plan.dense_threshold)
    res_h = hand.run(prog, pg)
    assert res_h.plan.source == "manual"
    want = JEngine(plan="auto", mode=mode, chunk_size=3).run(
        JREGISTRY[key].factory(**inputs), jpg)
    _same_but_route_impl(want.plan, plan)
    np.testing.assert_array_equal(np.asarray(res_a.output),
                                  np.asarray(res_h.output))
    if key.startswith("pagerank"):
        # float sums in another order than the JAX package's (ROADMAP
        # fault 4): the port's test_torch_engine tolerance
        np.testing.assert_allclose(res_a.output, np.asarray(want.output),
                                   rtol=1e-5, atol=1e-9)
    else:
        np.testing.assert_array_equal(res_a.output, np.asarray(want.output))
    for res in (res_h, want):
        assert (res_a.steps, res_a.halted) == (res.steps, res.halted)
        assert res_a.bytes_by_channel == res.bytes_by_channel
        assert res_a.msgs_by_channel == res.msgs_by_channel
    spec.check(g, pg, res_a, inputs)


def test_auto_bit_identical_fused_smoke():
    _assert_bit_identical("sssp:basic", "fused")


@pytest.mark.parametrize("mode", ("host", "fused", "chunked"))
@pytest.mark.parametrize("key", ("wcc:switch", "sssp:basic",
                                 "pagerank:scatter"))
def test_auto_bit_identical_sweep(key, mode):
    _assert_bit_identical(key, mode)


def test_batched_and_served_runs_carry_their_plan():
    spec, g, jpg, pg, inputs = _problem("reach:basic")
    prog = spec.factory(**inputs)
    queries = spec.queries(g, 0, 5)
    eng = Engine(device="cpu", plan="auto", mode="chunked", chunk_size=2)
    res = eng.run_batch(prog, pg, queries)
    assert res.plan.source == "auto" and res.plan.fingerprint.num_queries \
        == 8  # the bucket cap
    assert res.route_batch == res.plan.route_batch == "union"
    want = JEngine(plan="auto", mode="chunked", chunk_size=2).run_batch(
        JREGISTRY["reach:basic"].factory(**inputs), jpg, queries)
    _same_but_route_impl(want.plan, res.plan)
    for qi in range(len(queries)):
        np.testing.assert_array_equal(res.outputs[qi], want.outputs[qi])
        assert res.query_bytes(qi) == want.query_bytes(qi)
    served = eng.serve(prog, pg, queries, num_lanes=2, chunk_size=2)
    assert served.plan.source == "auto"
    assert served.plan.fingerprint.num_queries == 2
    for rec in served.records:
        np.testing.assert_array_equal(rec.output, res.outputs[rec.qid])


def test_hand_set_knobs_run_on_the_cpu_and_are_recorded(monkeypatch):
    """``dense_threshold`` runs and lands on the result; a given Plan's
    ``use_kernel=False`` and ``route_impl="sort"`` are recorded on the CPU,
    where the port's one plain path runs (never the sort baseline), every
    output equal to the default run's."""
    pg, prog = _prog("wcc:switch")
    calls = []
    real = routing._slots_sort
    monkeypatch.setattr(routing, "_slots_sort",
                        lambda k, w: calls.append(1) or real(k, w))
    base = Engine(device="cpu", mode="fused").run(prog, pg)
    for mode in ("host", "fused"):
        given = Plan(mode=mode, use_kernel=False, route_impl="sort",
                     dense_threshold=0.02)
        for eng in (Engine(device="cpu", mode=mode, dense_threshold=0.02),
                    Engine(device="cpu", plan=given)):
            res = eng.run(prog, pg)
            assert res.dense_threshold == 0.02
            assert res.plan.dense_threshold == 0.02
            np.testing.assert_array_equal(res.output, base.output)
            assert res.steps == base.steps
        assert res.plan is given
    assert not calls


def test_dense_threshold_is_part_of_the_loop_key():
    """A loop built under one threshold never replays under another: the
    threshold is in the key, each run under its own."""
    pg, prog = _prog("wcc:switch")
    eng = Engine(device="cpu", mode="fused", plan=Plan(dense_threshold=0.1))
    eng.run(prog, pg)
    eng.plan_policy = Plan(dense_threshold=0.02)
    res = eng.run(prog, pg)
    assert not res.cache_hit and eng.compiles == 2
    assert sorted(k[-1] for k in eng._cache) == [0.02, 0.1]
    assert res.dense_threshold == 0.02


# -- knob parity with the JAX planner -------------------------------------


def _same_plans(got, want):
    assert got.knobs() == want.knobs()
    assert got.fingerprint.to_json() == want.fingerprint.to_json()
    assert got.fingerprint.cache_key() == want.fingerprint.cache_key()
    assert [d.knob for d in got.decisions] == [d.knob for d in want.decisions]
    for d, e in zip(got.decisions, want.decisions):
        assert (d.chosen, d.source) == (e.chosen, e.source), d.knob
        assert [c[0] for c in d.candidates] == [c[0] for c in e.candidates]
        for c, f in zip(d.candidates, e.candidates):
            if f[1] is None:
                assert c[1] is None
            else:
                assert c[1] == pytest.approx(f[1], rel=1e-12)
            assert c[2] is None and f[2] is None


PARITY = [(k, 0) for k in REGISTRY] + [(k, 16) for k in BATCHED]


@pytest.mark.parametrize("key,q", PARITY, ids=[f"{k}-q{q}" for k, q in PARITY])
def test_corpus_only_plans_equal_the_jax_plans(key, q):
    spec, g, jpg, pg, inputs = _problem(key)
    got = Planner(calibrate=False).plan(spec.factory(**inputs), pg,
                                        num_queries=q)
    want = JPlanner(calibrate=False).plan(
        JREGISTRY[key].factory(**inputs), jpg, num_queries=q)
    _same_plans(got, want)


def test_plans_round_trip_through_json_across_the_packages():
    spec, g, jpg, pg, inputs = _problem("reach:basic")
    got = Planner(calibrate=False).plan(spec.factory(**inputs), pg,
                                        num_queries=16)
    want = JPlanner(calibrate=False).plan(
        JREGISTRY["reach:basic"].factory(**inputs), jpg, num_queries=16)
    into_jax = JPlan.from_json(json.dumps(got.to_json()))
    into_port = Plan.from_json(json.dumps(want.to_json()))
    _same_plans(got, into_jax)
    _same_plans(into_port, want)
    assert into_port.to_json() == want.to_json()
    assert into_jax.to_json() == got.to_json()
    # a JAX-written plan drives the port's engine
    res = Engine(device="cpu", plan=into_port).run(spec.factory(**inputs),
                                                   pg)
    assert res.plan is into_port and res.mode == into_port.mode


# -- the port's rules: the probe margin and the card ----------------------


def _inject(fp, probes):
    """Write ``probes`` into the port's probe cache for ``fp``."""
    path = cm.cache_dir() / f"{fp.cache_key()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"fingerprint": fp.to_json(),
                                "probes": probes}))


@pytest.mark.parametrize("lead", (1.2, 3.0))
def test_probe_margin_rule(lead):
    """A probe decides only when its winner leads by PROBE_MARGIN: at a
    1.2x lead the corpus fit decides (bucket, the reference), at 3x the
    probe does (sort, the kernel)."""
    pg, prog = _prog()
    fp = features.fingerprint(prog, pg)
    _inject(fp, {"route_bucket_s": 1e-3 * lead, "route_sort_s": 1e-3,
                 "combine_ref_s": 1e-3 * lead, "combine_kernel_s": 1e-3})
    plan = Planner().plan(prog, pg)
    route, kern = plan.decision("route_impl"), plan.decision("use_kernel")
    if lead < planning.PROBE_MARGIN:
        assert (plan.route_impl, plan.use_kernel) == ("bucket", False)
        assert "corpus fit" in route.reason and "1.20x" in route.reason
        assert "corpus fit" in kern.reason
    else:
        assert (plan.route_impl, plan.use_kernel) == ("sort", True)
        assert "measured probe, 3.00x margin" in route.reason
    assert dict((c[0], c[2]) for c in route.candidates) == {
        "bucket": pytest.approx(1e-3 * lead), "sort": 1e-3}


@pytest.mark.parametrize("explain", (False, True))
def test_a_cuda_fingerprint_plans_the_kernels(explain, monkeypatch):
    """On the card ``use_kernel`` is True, ``route_impl`` is
    ``"bucket"`` and ``dense_threshold`` the default, whatever the
    evidence (the CPU corpus's curves do not apply there). The probes
    decide nothing, so only a plan to be explained reads them: its
    candidates keep the probes' costs, and ``explain`` shows the
    margin."""
    pg, prog = _prog()
    fp = features.fingerprint(prog, pg, backend="cuda")
    assert fp.backend == "cuda" and fp.cache_key() != \
        features.fingerprint(prog, pg).cache_key()
    _inject(fp, {"route_bucket_s": 3e-3, "route_sort_s": 1e-3,
                 "combine_ref_s": 1e-3, "combine_kernel_s": 3e-3})
    monkeypatch.setattr(cm, "_run_probes", lambda fp: pytest.fail("probe"))
    plan = Planner(explain=explain)._decide(fp, {})
    assert (plan.use_kernel, plan.route_impl, plan.dense_threshold) == (
        True, "bucket", 0.1)
    for knob in ("use_kernel", "route_impl"):
        dec = plan.decision(knob)
        assert dec.source == "planner"
        assert "one legal value on the card" in dec.reason
    assert "no card corpus" in plan.decision("dense_threshold").reason
    kern = dict((c[0], c[1:]) for c in plan.decision("use_kernel").candidates)
    assert kern["kernel"][0] is None  # the CPU corpus curve does not apply
    measured = [c[2] for knob in ("use_kernel", "route_impl")
                for c in plan.decision(knob).candidates]
    if explain:
        assert "3.00x margin" in plan.decision("route_impl").reason
        assert "3.000ms" in plan.explain()
    else:
        assert measured == [None] * 4


def test_cpu_probes_time_the_plain_paths_and_cache_them(monkeypatch):
    pg, prog = _prog()
    fp = features.fingerprint(prog, pg)
    before = ops.launch_counts()
    probes = cm.calibrate(fp)
    assert ops.launch_counts() == before
    assert set(probes) == {"m_probe", "e_probe", "route_bucket_s",
                           "route_sort_s", "combine_ref_s"}
    assert all(v > 0 for v in probes.values())
    # the kernel candidate has no CPU timing: the corpus decides
    assert cm.CostModel(fp, cm.Corpus.load(), probes).combine_costs()[
        "kernel"]["measured"] is None
    monkeypatch.setattr(cm, "_run_probes", lambda fp: pytest.fail("cold"))
    assert cm.calibrate(fp) == probes  # warm: read back from disk


def test_the_port_never_reads_a_jax_probe_cache(tmp_path, monkeypatch):
    """On the CPU both fingerprints hash alike; a JAX probe file under the
    same key, in the JAX default directory, is not the port's."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE")
    monkeypatch.delenv("REPRO_PLAN_CACHE")
    spec, g, jpg, pg, inputs = _problem()
    fp = features.fingerprint(spec.factory(**inputs), pg)
    jfp = jcm.Fingerprint.from_json(fp.to_json())
    assert jfp.cache_key() == fp.cache_key()
    assert jcm.cache_dir() != cm.cache_dir()
    assert str(cm.cache_dir()) == ".repro_torch_plan_cache"
    fake = {"route_bucket_s": 9.0, "route_sort_s": 1e-6,
            "combine_ref_s": 9.0, "combine_kernel_s": 1e-6}
    path = jcm.cache_dir() / f"{fp.cache_key()}.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"fingerprint": fp.to_json(),
                                "probes": fake}))
    assert jcm.calibrate(jfp) == fake  # the JAX package reads it
    got = cm.calibrate(fp)
    assert got["route_bucket_s"] != 9.0 and "combine_kernel_s" not in got
    assert (cm.cache_dir() / f"{fp.cache_key()}.json").is_file()


# -- cross-process determinism ------------------------------------------

_SNIPPET = """
import json
from repro_torch.algorithms import REGISTRY
from repro_torch.graph import pgraph
from repro_torch.plan import Planner

spec = REGISTRY["sssp:basic"]
graph = spec.make_graph(8, 0)
pg = pgraph.partition_graph(graph, 4, "random", build=spec.build,
                            device="cpu")
prog = spec.factory(**spec.inputs(graph, 0))
plan = Planner().plan(prog, pg)
print(json.dumps({"knobs": plan.knobs(),
                  "fp": plan.fingerprint.cache_key()}, sort_keys=True))
"""


def test_plan_deterministic_across_processes(tmp_path):
    """Same problem, two fresh interpreters: the first fills the probe
    cache (cold), the second reads it (warm); both give the same plan."""
    def run_once(cache_dir):
        env = {**os.environ, "REPRO_TORCH_PLAN_CACHE": str(cache_dir),
               "PYTHONPATH": os.path.join(ROOT, "src")}
        out = subprocess.run([sys.executable, "-c", _SNIPPET],
                             capture_output=True, text=True, env=env,
                             check=True, timeout=120)
        return json.loads(out.stdout.strip().splitlines()[-1])

    cache = tmp_path / "cache"
    cold = run_once(cache)
    assert cache.exists() and list(cache.glob("*.json"))
    warm = run_once(cache)
    assert cold == warm, f"cold={cold} warm={warm}"
