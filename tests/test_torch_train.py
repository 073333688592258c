"""The port's training substrate (``repro_torch.train``,
``distributed.compression``, ``TrainSupervisor``, ``launch.train``,
``train_lm``) against the JAX package's, the counterpart of
tests/test_train.py, ``test_checkpoint_elastic_reshard`` included: a
checkpoint restores with ``shardings=`` onto a (1, 1) mesh of one gloo
rank in this process, and a JAX checkpoint onto a (1, 2) mesh of two
gloo CPU ranks (tests/torch_spmd_ranks.py). Inputs are made with numpy
or by the JAX package and carried across as numpy.

Tolerances: the optimizer is fed the same gradients in both packages and
held within rtol 1e-6 / atol 1e-9 (float32 elementwise arithmetic in the
same order; the global norm sums leaves in another order, and XLA's pow
and sqrt may round apart by an ulp). A whole step compares the loss
within 1e-6, grad_norm within 1e-5 (a float32 sum of every square in
another order) and the updated parameters within 1e-6 of a 1e-5 update:
a gradient at rounding level that changed sign would move a parameter
by about 2e-5 and fail it.
"""
import contextlib
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.distributed.fault_tolerance import TrainSupervisor as JSupervisor
from repro.models.config import ModelConfig as JConfig
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import train_step as jts
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import train_step as tts
from repro_torch.train.optimizer import AdamW as TAdamW

_TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab=61, dtype="float32")
JTINY, TTINY = JConfig(**_TINY), TConfig(**_TINY)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs a worker a core, and
    these small tensors' parallel regions stall on many threads a worker
    (a 100-step TINY run went from 2 s to 107 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flat(tree, prefix=()):
    """{path: leaf} of a tree of nested dicts (torch or JAX leaves)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def as_np(t):
    """A leaf as float32/int numpy (bfloat16 widened exactly)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_trees(got, want, rtol=0.0, atol=0.0, leaf_atol=0.0):
    """Leaf by leaf within rtol, plus atol and ``leaf_atol`` times the
    leaf's largest magnitude."""
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for k in w:
        want_k = as_np(w[k])
        scale = float(np.abs(want_k).max()) if want_k.size else 0.0
        np.testing.assert_allclose(as_np(g[k]), want_k, rtol=rtol,
                                   atol=atol + leaf_atol * scale,
                                   err_msg=str(k))


def jax_state(opt, seed=0, cfg=JTINY):
    return jts.init_train_state(cfg, opt, jax.random.PRNGKey(seed))


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the optimizer, fed the same gradients
# ---------------------------------------------------------------------------


def _opt_inputs(seed):
    """A parameter tree with 1-d and stacked leaves, and two gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (13, 8), "final_norm": (8,),
              "blocks": {"l0": {"wq": (2, 8, 8), "norm": (2, 8)}}}

    def draw(shape, scale):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    params = jax.tree_util.tree_map(lambda s: draw(s, 0.5), shapes,
                                    is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(lambda s: draw(s, 0.3), shapes,
                                    is_leaf=lambda s: isinstance(s, tuple))
             for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("v_dtype", [None, "bfloat16"])
def test_adamw_update_equals_jax(clip, v_dtype):
    """Two updates (warm-up, the bias corrections, the clip, decay on
    ndim >= 2 only): params, m, v, gnorm and lr against the JAX update."""
    params, grads = _opt_inputs(3)
    kw = dict(lr=1e-2, grad_clip=clip, warmup_steps=3, v_dtype=v_dtype)
    jopt, topt = JAdamW(**kw), TAdamW(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jopt.init(jp)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    tst = topt.init(tp)
    for g in grads:
        jp, jst, jn = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jst, jp)
        tg = tree_map(lambda a: torch.from_numpy(a.copy()), g)
        tp, tst, tn = topt.update(tg, tst, tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(tst.step) == int(jst.step)
        np.testing.assert_allclose(float(topt.schedule(tst.step)),
                                   float(jopt.schedule(jst.step)), rtol=0)
        assert_trees(tp, jp, rtol=1e-6, atol=1e-9)
        assert_trees(tst.m, jst.m, rtol=1e-6, atol=1e-9)
        assert_trees(tst.v, jst.v, rtol=1e-6 if v_dtype is None else 8e-3,
                     atol=1e-9)
    if v_dtype:
        assert all(v.dtype == torch.bfloat16 for v in tree_leaves(tst.v))
    if clip == 0:
        assert float(tn) == 0.0
    # decoupled decay: the 1-d leaf decays not at all
    zero = tree_map(lambda a: torch.zeros_like(torch.from_numpy(a)), params)
    p0 = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    p1, _, _ = TAdamW(lr=1e-2, warmup_steps=1).update(
        zero, TAdamW().init(p0), p0)
    assert torch.equal(p1["final_norm"], torch.from_numpy(params["final_norm"]))
    assert not torch.equal(p1["embed"], torch.from_numpy(params["embed"]))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_equals_jax(masked):
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(3, 7, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6) if masked else None
    want = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = tts.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if masked:  # an all-False mask divides by 1, not 0
        z = tts.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.zeros(3, 7, dtype=torch.bool))
        assert float(z) == 0.0


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches,grad_dtype", [
    (1, "float32"), (4, "float32"), (4, "bfloat16")])
def test_train_step_equals_jax(microbatches, grad_dtype):
    """One step from the JAX state on the JAX batch: loss, grad_norm, lr
    and every updated leaf against the JAX ``make_train_step``; with a
    bfloat16 ``grad_dtype`` the microbatches' gradients are summed and
    divided in bfloat16, as in JAX."""
    jopt, topt = JAdamW(lr=1e-3), TAdamW(lr=1e-3)
    js = jax_state(jopt)
    batch = jdata.SyntheticLM(JTINY, seq_len=16, global_batch=8).batch_at(0)
    js2, jm = jax.jit(jts.make_train_step(
        JTINY, jopt, microbatches=microbatches,
        grad_dtype=getattr(jnp, grad_dtype)))(js, batch)
    ts_ = tts.from_jax(np_tree(js), "cpu")
    ts2, tm = tts.make_train_step(
        TTINY, topt, microbatches=microbatches,
        grad_dtype=getattr(torch, grad_dtype))(ts_, torch_batch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    # the norm sums every square in float32, in another order
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts2.opt.step) == int(js2.opt.step) == 1
    assert_trees(ts2.params, js2.params, rtol=1e-6, atol=1e-6)
    # m and v hold (1 - b) g and (1 - b) g^2: the gradients themselves,
    # which agree to about 2e-5 relative, 1e-8 absolute (float32 sums in
    # another order); summed in bfloat16, such a difference can round a
    # partial sum to a neighbouring bfloat16 value: 2^-8 of the partial
    # sums' size, bounded here by the leaf's largest entry
    leaf = 0.0 if grad_dtype == "float32" else 2.0 ** -8
    assert_trees(ts2.opt.m, js2.opt.m, rtol=1e-4, atol=1e-7, leaf_atol=leaf)
    assert_trees(ts2.opt.v, js2.opt.v, rtol=1e-4, atol=1e-10,
                 leaf_atol=2 * leaf)
    assert ts2.params is ts_.params  # updated in place


def test_grad_accumulation_equivalence():
    """microbatches=4 gives the same update as microbatches=1 (the JAX
    test's tolerances), and as JAX's microbatches=4 (the tight ones)."""
    jopt, topt = JAdamW(lr=1e-3, grad_clip=0), TAdamW(lr=1e-3, grad_clip=0)
    js = jax_state(jopt)
    batch = jdata.SyntheticLM(JTINY, seq_len=16, global_batch=8).batch_at(0)
    out = {}
    for mb in (1, 4):
        out[mb] = tts.make_train_step(TTINY, topt, microbatches=mb)(
            tts.from_jax(np_tree(js), "cpu"), torch_batch(batch))
    (s1, m1), (s4, m4) = out[1], out[4]
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    assert_trees(s4.params, s1.params, rtol=1e-4, atol=1e-6)
    j4, jm4 = jax.jit(jts.make_train_step(JTINY, jopt, microbatches=4))(
        js, batch)
    np.testing.assert_allclose(float(m4["loss"]), float(jm4["loss"]),
                               rtol=1e-6)
    assert_trees(s4.params, j4.params, rtol=1e-6, atol=1e-6)


def test_loss_decreases_100_steps():
    opt = TAdamW(lr=3e-3, warmup_steps=10)
    state = tts.init_train_state(TTINY, opt, torch.Generator().manual_seed(0),
                                 device="cpu")
    step = tts.make_train_step(TTINY, opt)
    pipe = tdata.SyntheticLM(TTINY, seq_len=32, global_batch=8, device="cpu")
    losses = []
    for i in range(100):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2
    assert np.all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-moe-a2.7b",
                                  "internvl2-2b"])
def test_backward_is_bit_identical_run_to_run(arch):
    """Two backward passes at 8 x 256 tokens give the same bits. The
    token embedding is ``F.embedding`` (a departure from the JAX
    package's indexing, same values): the backward of indexing
    accumulates repeated tokens in parallel on the CPU and its sums vary
    from run to run at this size."""
    from repro_torch.configs import registry

    cfg, opt = registry.ARCHS[arch].smoke, TAdamW()
    batch = tdata.SyntheticLM(cfg, 256, 8, device="cpu").batch_at(3)
    runs = []
    for _ in range(2):
        st = tts.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                  device="cpu")
        leaves = tree_leaves(st.params)
        for p in leaves:
            p.requires_grad_(True)
        tts.make_loss_fn(cfg)(st.params, batch).backward()
        runs.append([p.grad for p in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# data, specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontend", ["none", "audio_frames",
                                      "vision_patches"])
def test_data_pipeline_deterministic_and_restartable(frontend):
    """Each batch a pure function of (seed, step, host), with the JAX
    batch's keys, shapes and dtypes and its stream (labels are the
    tokens shifted by one)."""
    extra = {} if frontend == "none" else dict(
        frontend=frontend, frontend_tokens=4 if frontend == "vision_patches"
        else 0)
    jc, tc = JConfig(**_TINY, **extra), TConfig(**_TINY, **extra)
    pipe = tdata.SyntheticLM(tc, seq_len=16, global_batch=4, seed=9,
                             device="cpu")
    a = pipe.batch_at(42)
    b = tdata.SyntheticLM(tc, seq_len=16, global_batch=4, seed=9,
                          device="cpu").batch_at(42)
    for k in a:
        assert torch.equal(a[k], b[k])
    c = pipe.batch_at(43)
    assert not torch.equal(a["labels"], c["labels"])
    assert not torch.equal(a["labels"], pipe.batch_at(42, 1, 2)["labels"])
    assert pipe.batch_at(42, 1, 2)["labels"].shape[0] == 2
    want = jdata.SyntheticLM(jc, seq_len=16, global_batch=4,
                             seed=9).batch_at(42)
    assert set(a) == set(want)
    for k, v in want.items():
        assert tuple(a[k].shape) == tuple(v.shape), k
        assert str(a[k].dtype).split(".")[-1] == str(v.dtype), k
    if "tokens" in a:
        assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
        assert int(a["tokens"].max()) < tc.vocab


def test_batch_and_train_state_specs_match_jax():
    """``batch_specs`` of every kind and frontend and the ``meta`` train
    state of every full registry config: shapes and dtypes as JAX's."""
    from repro.configs import registry as JR
    from repro_torch.configs import registry as TR

    for arch in JR.ARCHS:
        jc, tc = JR.ARCHS[arch].config, TR.ARCHS[arch].config
        for kind in ("train", "prefill", "decode"):
            want = jdata.batch_specs(jc, 512, 4, kind)
            got = tdata.batch_specs(tc, 512, 4, kind)
            assert set(got) == set(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
                assert got[k].device.type == "meta"
        opt = dict(v_dtype="bfloat16") if arch == "qwen2-moe-a2.7b" else {}
        want = jts.train_state_specs(jc, JAdamW(**opt))
        got = tts.train_state_specs(tc, TAdamW(**opt))
        assert tuple(got.opt.step.shape) == want.opt.step.shape == ()
        for part in ("m", "v"):
            g, w = flat(getattr(got.opt, part)), flat(getattr(want.opt, part))
            assert set(g) == set(w)
            for k in w:
                assert tuple(g[k].shape) == w[k].shape
                assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_compress_grads_bit_equal_to_jax():
    """bf16 values and the float32 residual bit for bit, over three steps
    of error feedback; without feedback a plain cast."""
    rng = np.random.default_rng(8)
    grads = {"a": (rng.normal(size=(5, 7)) * 1e-3).astype(np.float32),
             "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}
    jst = jcomp.init_state(jax.tree_util.tree_map(jnp.asarray, grads))
    tg = tree_map(torch.from_numpy, grads)
    tst = tcomp.init_state(tg)
    for _ in range(3):
        jq, jst = jcomp.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, grads), jst)
        tq, tst = tcomp.compress_grads(tg, tst)
        for k, w in flat(np_tree(jq)).items():
            assert np.array_equal(flat(tq)[k].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))
        for k, w in flat(np_tree(jst.error)).items():
            assert np.array_equal(flat(tst.error)[k].numpy(), w)
    plain, st = tcomp.compress_grads(tg, tcomp.init_state(tg, False))
    assert st.error is None and plain["a"].dtype == torch.bfloat16
    back = tcomp.decompress_grads(tq)
    assert back["a"].dtype == torch.float32


def test_gradient_compression_error_feedback():
    """bf16 with error feedback accumulates to the fp32 mean over steps."""
    g = torch.full((1000,), 1e-3 + 3e-8, dtype=torch.float32)
    state = tcomp.init_state({"g": g})
    total = torch.zeros_like(g)
    for _ in range(64):
        q, state = tcomp.compress_grads({"g": g}, state)
        total = total + q["g"].float()
    np.testing.assert_allclose(float(total.mean()) / 64, float(g[0]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _torch_state(opt, seed=1):
    return tts.init_train_state(TTINY, opt, torch.Generator().manual_seed(
        seed), device="cpu")


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A gloo group of one rank in this process and its (1, 1) mesh,
    destroyed on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_local_mesh()
    finally:
        dist.destroy_process_group()


def test_checkpoint_roundtrip_and_layout(tmp_path):
    """Round trip bit for bit (in place into a target that holds memory,
    new tensors for a ``meta`` target), the JAX paths and sorted order in
    the manifest, and ``shardings=`` placing every leaf on a mesh."""
    opt = TAdamW(v_dtype="bfloat16")
    state = _torch_state(opt)
    state.opt.v["embed"].normal_()  # bf16 bits worth keeping
    tckpt.save(str(tmp_path), 7, state)
    assert tckpt.latest_step(str(tmp_path)) == 7
    d = tmp_path / "step_00000007"
    manifest = json.loads((d / "manifest.json").read_text())
    paths = [leaf["path"] for leaf in manifest["leaves"]]
    # JAX's flatten order: NamedTuple fields in order, dict keys sorted
    assert paths[0] == "params/blocks/l0/norm_mixer" and "opt/step" in paths
    assert paths.index("params/final_norm") < paths.index("opt/step") < \
        paths.index("opt/m/blocks/l0/norm_mixer")
    dt = {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}
    assert dt["opt/v/embed"] == "bfloat16" and dt["opt/step"] == "int32"
    target = _torch_state(opt, seed=5)
    got = tckpt.restore(str(tmp_path), target)
    assert got.params["embed"] is target.params["embed"]
    want = flat({"params": state.params, "m": state.opt.m, "v": state.opt.v})
    have = flat({"params": got.params, "m": got.opt.m, "v": got.opt.v})
    for k in want:
        assert have[k].dtype == want[k].dtype
        assert torch.equal(have[k].view(torch.int16) if have[k].dtype ==
                           torch.bfloat16 else have[k],
                           want[k].view(torch.int16) if want[k].dtype ==
                           torch.bfloat16 else want[k]), k
    assert int(got.opt.step) == 0
    specs = tts.train_state_specs(TTINY, opt)
    fresh = tckpt.restore(str(tmp_path), specs, device="cpu")
    assert torch.equal(fresh.params["embed"], state.params["embed"])
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as sh

    with one_rank_mesh(tmp_path) as mesh:
        placed = tckpt.restore(str(tmp_path), specs, device="cpu",
                               shardings=sh.named(mesh, sh.train_state_pspecs(
                                   TTINY, mesh)))
        assert isinstance(placed.params["embed"], DTensor)
        assert torch.equal(placed.params["embed"].to_local(),
                           state.params["embed"])
        assert torch.equal(placed.opt.v["embed"].to_local().view(torch.int16),
                           state.opt.v["embed"].view(torch.int16))
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), target)


def test_checkpoint_elastic_reshard(tmp_path):
    """The counterpart of the JAX test: a checkpoint saved unsharded
    restores onto a (1, 1) mesh, every leaf a DTensor equal bit for bit
    (into a sharded target in place too)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as sh

    opt = TAdamW()
    state = _torch_state(opt)
    tckpt.save(str(tmp_path), 3, state)
    with one_rank_mesh(tmp_path) as mesh:
        shardings = sh.named(mesh, sh.train_state_pspecs(TTINY, mesh))
        restored = tckpt.restore(str(tmp_path), tts.train_state_specs(
            TTINY, opt), shardings=shardings, device="cpu")
        leaves = tree_leaves(restored.params)
        assert all(isinstance(t, DTensor) for t in leaves)
        for a, b in zip(tree_leaves(state.params), leaves):
            assert torch.equal(a, b.to_local())
        target = tts.init_train_state(TTINY, opt, torch.Generator()
                                      .manual_seed(9), device="cpu",
                                      mesh=mesh)
        again = tckpt.restore(str(tmp_path), target)
        assert again.params["embed"] is target.params["embed"]
        for a, b in zip(tree_leaves(state.opt.m), tree_leaves(again.opt.m)):
            assert torch.equal(a, b.to_local())


def test_jax_checkpoint_restores_onto_a_1x2_mesh(tmp_path):
    """A JAX checkpoint restored with ``shardings=`` on two gloo CPU ranks:
    every leaf a DTensor with its spec's placements, each rank holding
    half of the model-split leaves, gathered back equal bit for bit."""
    import torch_spmd_ranks as ranks

    from repro_torch.launch import workers

    jopt = JAdamW()
    js = jts.init_train_state(JTINY, jopt, jax.random.PRNGKey(2))
    jckpt.save(str(tmp_path), 4, js)
    out = workers.spawn(ranks.restore, 2, (1, 2), _TINY, str(tmp_path),
                        device="cpu", timeout_s=60, threads=1)
    whole = sum(4 * int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(js.params))
    for o in out:
        assert o["placed"] and o["placements_ok"]
        assert o["local_bytes"] < whole
        assert o["step"] == int(js.opt.step)
        for got, want in ((o["params"], js.params), (o["m"], js.opt.m)):
            for a, b in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(np_tree(want))):
                np.testing.assert_array_equal(a, b)


def test_checkpoint_is_atomic_and_async(tmp_path):
    """A writer that died before its rename leaves a ``tmp.*`` directory
    that no reader sees; a save over an existing step replaces it; an
    async save is whole once its thread is joined."""
    opt = TAdamW()
    state = _torch_state(opt)
    (tmp_path / "tmp.9.0").mkdir()  # a crashed writer's leftovers
    assert tckpt.latest_step(str(tmp_path)) is None
    t = tckpt.save(str(tmp_path), 3, state, blocking=False)
    assert isinstance(t, threading.Thread)
    t.join()
    assert tckpt.latest_step(str(tmp_path)) == 3
    assert not (tmp_path / "tmp.3.0").exists()
    state.params["embed"].add_(1.0)
    tckpt.save(str(tmp_path), 3, state)
    got = tckpt.restore(str(tmp_path), _torch_state(opt, seed=2))
    assert torch.equal(got.params["embed"], state.params["embed"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "tmp.9.0"]


def test_checkpoints_cross_load_between_the_packages(tmp_path):
    """A JAX-written state (bfloat16 v included) restores in the port bit
    for bit; a port-written float32 state restores in JAX bit for bit. A
    bfloat16 leaf is stored as JAX stores it (2-byte words, manifest
    "bfloat16"): the two files hold the same bytes, and the JAX restore
    refuses both alike (ROADMAP fault 12)."""
    jopt = JAdamW(v_dtype="bfloat16")
    js = jax_state(jopt, seed=3)
    js = js._replace(opt=js.opt._replace(
        step=jnp.asarray(4, jnp.int32),
        v=jax.tree_util.tree_map(
            lambda v: jax.random.normal(jax.random.PRNGKey(2), v.shape,
                                        jnp.bfloat16), js.opt.v)))
    jckpt.save(str(tmp_path / "jax"), 4, js)
    topt = TAdamW(v_dtype="bfloat16")
    got = tckpt.restore(str(tmp_path / "jax"), _torch_state(topt))
    assert int(got.opt.step) == 4
    want = tts.from_jax(np_tree(js), "cpu")
    for part in ("params", "m", "v"):
        src = got.params if part == "params" else getattr(got.opt, part)
        ref = want.params if part == "params" else getattr(want.opt, part)
        for k, w in flat(ref).items():
            h = flat(src)[k]
            assert h.dtype == w.dtype
            assert torch.equal(h.view(torch.int16), w.view(torch.int16)) \
                if w.dtype == torch.bfloat16 else torch.equal(h, w), k
    # the port writes the same bytes
    tckpt.save(str(tmp_path / "port"), 4, want)
    jnpz = np.load(tmp_path / "jax" / "step_00000004" / "shard_0.npz")
    tnpz = np.load(tmp_path / "port" / "step_00000004" / "shard_0.npz")
    assert sorted(jnpz.files) == sorted(tnpz.files)
    for k in jnpz.files:
        assert jnpz[k].dtype == tnpz[k].dtype
        assert jnpz[k].tobytes() == tnpz[k].tobytes(), k
    jm = json.loads((tmp_path / "jax" / "step_00000004" /
                     "manifest.json").read_text())
    tm = json.loads((tmp_path / "port" / "step_00000004" /
                     "manifest.json").read_text())
    assert jm == tm
    for d in ("jax", "port"):  # fault 12: the JAX restore cannot cast V2
        with pytest.raises(ValueError, match="No cast function"):
            jckpt.restore(str(tmp_path / d), js)
    # float32 state: port-written, JAX-restored, bit for bit
    tstate = _torch_state(TAdamW(), seed=6)
    tstate.opt.m["embed"].normal_()
    tckpt.save(str(tmp_path / "f32"), 2, tstate)
    jback = jckpt.restore(str(tmp_path / "f32"), jax_state(JAdamW()))
    for k, w in flat(jback.params).items():
        assert np.array_equal(np.asarray(w), flat(tstate.params)[k].numpy())
    for k, w in flat(jback.opt.m).items():
        assert np.array_equal(np.asarray(w), flat(tstate.opt.m)[k].numpy())


def test_supervisor_resume_equals_an_uninterrupted_run(tmp_path):
    """11 steps with a checkpoint every 5, a "crash", a new supervisor
    resuming from step 10's checkpoint and running to 16: every array bit
    for bit the straight 16-step run's; keep-last GC; finalize joins the
    save in flight. The JAX test's assertions too."""
    opt = TAdamW(lr=1e-3)
    step = tts.make_train_step(TTINY, opt)
    pipe = tdata.SyntheticLM(TTINY, seq_len=16, global_batch=4,
                             device="cpu")
    init = lambda: _torch_state(opt, seed=0)

    straight = init()
    for i in range(16):
        straight, _ = step(straight, pipe.batch_at(i))

    sup = TrainSupervisor(str(tmp_path), save_every=5, async_save=False,
                          keep_last=2)
    state, start = sup.restore_or(init)
    assert start == 0
    for i in range(11):
        state, _ = step(state, pipe.batch_at(i))
        sup.maybe_save(i, state)
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000010"]
    sup2 = TrainSupervisor(str(tmp_path), save_every=5)
    state2, start2 = sup2.restore_or(init)
    assert start2 == 11
    assert int(state2.opt.step) == int(state.opt.step) == 11
    for i in range(start2, 16):
        state2, _ = step(state2, pipe.batch_at(i))
        sup2.maybe_save(i, state2)
    sup2.finalize(15, state2)
    for a, b in zip(tree_leaves(dict(straight.params)),
                    tree_leaves(dict(state2.params))):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(straight.opt.m) + tree_leaves(straight.opt.v),
                    tree_leaves(state2.opt.m) + tree_leaves(state2.opt.v)):
        assert torch.equal(a, b)
    assert tckpt.latest_step(str(tmp_path)) == 15
    prev = sup2.install_preemption_handler()
    try:
        assert not sup2.preempted
        assert sup2.maybe_save(16, state2, force=True)
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_supervisor_matches_the_jax_schedule(tmp_path):
    """Which steps the two supervisors save, and what they keep."""
    saved = {}
    for name, cls, save in (("jax", JSupervisor, jckpt.save),
                            ("port", TrainSupervisor, tckpt.save)):
        d = tmp_path / name
        sup = cls(str(d), save_every=3, async_save=False, keep_last=2)
        state = {"x": np.zeros(2, np.float32)} if name == "jax" else {
            "x": torch.zeros(2)}
        saved[name] = [i for i in range(10) if sup.maybe_save(i, state)]
        sup.finalize(9, state)
        saved[name].append(sorted(os.listdir(d)))
    assert saved["jax"] == saved["port"]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "mamba2-130m", "--smoke", "--seq-len", "16",
            "--global-batch", "2", "--device", "cpu", "--log-every", "2",
            "--ckpt-dir", str(tmp_path), "--save-every", "2"]
    assert train.main(argv + ["--steps", "3"]) == 0
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert train.main(argv + ["--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "[train] done. loss" in out
    assert tckpt.latest_step(str(tmp_path)) == 4
    assert train.main(argv + ["--steps", "5"]) == 0  # nothing left to run
    assert "nothing to run" in capsys.readouterr().out
    # the checkpoint of the single-device run resumes on a (1, 2) mesh of
    # two gloo ranks, whose own checkpoint holds the whole state again
    assert train.main(argv + ["--steps", "7", "--mesh", "1x2"]) == 0
    assert tckpt.latest_step(str(tmp_path)) == 6
    assert train.main(argv + ["--steps", "8"]) == 0
    assert "resumed from step 7" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train.main(argv + ["--mesh", "2x"])
    assert "--mesh" in capsys.readouterr().err


def test_launch_train_puts_the_sigterm_handler_back(tmp_path, monkeypatch):
    """The supervisor's handler lives only as long as main's loop, also
    when the loop raises."""
    from repro_torch.launch import train

    def mine(signum, frame):
        pass

    prev = signal.signal(signal.SIGTERM, mine)
    try:
        argv = ["--arch", "mamba2-130m", "--smoke", "--seq-len", "8",
                "--global-batch", "2", "--device", "cpu", "--steps", "1",
                "--ckpt-dir", str(tmp_path)]
        assert train.main(argv) == 0
        assert signal.getsignal(signal.SIGTERM) is mine

        def fail(self, init_fn):
            assert signal.getsignal(signal.SIGTERM) is not mine
            raise RuntimeError("restore failed")

        monkeypatch.setattr(TrainSupervisor, "restore_or", fail)
        with pytest.raises(RuntimeError, match="restore failed"):
            train.main(argv)
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_train_lm_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch import train_lm

    assert train_lm.main(["--steps", "2", "--seq-len", "16",
                          "--global-batch", "4", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "mamba2-100m-example" in out and "done: final loss" in out
    assert tckpt.latest_step(str(tmp_path)) == 1
    assert train_lm.DEFAULT_CKPT.parts[-2:] == ("build", "train_lm")


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without --device both entry points ask for CUDA and raise here."""
    from repro_torch import train_lm
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.SyntheticLM(TTINY, 4, 2).batch_at(0)
