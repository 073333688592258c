"""The port's SPMD MoE (``repro_torch.distributed.moe_spmd``), the sharded
forward and train step and ``launch.train --mesh``, against the JAX
package, on gloo CPU ranks (``launch.workers.spawn``; the per-rank code is
in tests/torch_spmd_ranks.py, which imports no JAX).

Tolerances: the MoE on a (1, 1) mesh is the JAX test's
(``tests/test_models.py::test_spmd_moe_matches_local``: rtol 1e-4, atol
1e-5); ``moe_local`` at an expert offset rtol / atol 1e-5 (the tolerance of
``test_torch_lm_layers.py``'s ``moe_local`` test: the JAX layer
scatter-adds the k choices, the port sums them in a fixed order); the sharded MoE layers and the smoke forwards rtol /
atol 1e-4 (``test_torch_lm_model.py``'s forward tolerance:
tensor-parallel products sum their halves in another order); the train
step ``test_torch_train.py``'s (loss 1e-6, grad_norm 1e-5, parameters
1e-6 + 1e-6, m and v 1e-4). A data=2 MoE step is held to
the JAX step at microbatches=2: the capacity is each data shard's, as it
is each microbatch's. Sharded serving (prefill and decode steps on
caches placed by ``cache_pspecs``, ``sample`` on vocabulary-split
logits, ``generate``) is held to the unsharded port's steps on the same
weights at rtol / atol 1e-4 (the forward's tolerance), its prefill to the
JAX forward at the same tolerance, and its greedy tokens exactly. In
bfloat16 the sharded forward equals the unsharded one bit for bit here:
row-parallel products and the MoE's replies are summed over "model" in
float32 and rounded once, as the unsharded products round.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_spmd_ranks as ranks
from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import params as JP
from repro.models.config import ModelConfig as JConfig
from repro.train import data as jdata
from repro.train import train_step as jts
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.distributed import context
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.moe_spmd import make_spmd_moe
from repro_torch.launch import workers
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers as TL
from repro_torch.models import params as TP
from repro_torch.models.config import ModelConfig as TConfig

MOE_KW = dict(name="m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
              d_ff=0, vocab=11, moe_experts=4, moe_top_k=2, moe_ff=8,
              moe_shared_ff=16, capacity_factor=8.0, dtype="float32")


def moe_inputs(e=4, ff=8, seed=4):
    """The JAX test's weights and tokens (``rng(4)``)."""
    rng = np.random.default_rng(seed)
    d = 16
    lp = {
        "router": rng.normal(size=(d, e)),
        "moe_w1": rng.normal(size=(e, d, ff)),
        "moe_w2": rng.normal(size=(e, ff, d)),
        "moe_w3": rng.normal(size=(e, d, ff)),
        "shared_w1": rng.normal(size=(d, 16)),
        "shared_w2": rng.normal(size=(16, d)),
        "shared_w3": rng.normal(size=(d, 16)),
        "shared_gate": rng.normal(size=(d, 1)),
    }
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    return lp, x


@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of one rank in this process and its (1, 1) mesh,
    destroyed afterwards."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_local_mesh()
    finally:
        dist.destroy_process_group()


def test_spmd_moe_matches_local(one_rank):
    """The counterpart of the JAX test: ``make_spmd_moe`` on a (1, 1) mesh
    (DTensor inputs, ``local_map``) equals the JAX local MoE layer."""
    lp, x = moe_inputs()
    want = JL.moe_layer(JConfig(**MOE_KW), {k: jnp.asarray(v)
                                            for k, v in lp.items()},
                        jnp.asarray(x))
    cfg, mesh = TConfig(**MOE_KW), one_rank
    tlp = sh.distribute(TP.from_jax(lp, "cpu"), mesh,
                        {k: sh.Spec() for k in lp})
    tx = sh.place(torch.as_tensor(x), sh.NamedSharding(mesh, sh.Spec()))
    with context.activation_sharding(mesh):
        got = make_spmd_moe(cfg, mesh)(cfg, tlp, tx)
    # the sum over "model" is done: nothing pending
    assert not any(p.is_partial() for p in got.placements)
    np.testing.assert_allclose(got.full_tensor().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", [3, 40])
def test_moe_local_at_an_expert_offset_equals_jax(t):
    """``moe_local(expert_lo=2, n_local_experts=2)`` on experts 2..3's
    weights: the JAX function's output (pairs of experts 0..1 add
    nothing; capacity from all E experts): at t=3 (no more tokens than
    experts) nothing drops, at t=40 the capacity drops pairs."""
    kw = dict(MOE_KW, moe_experts=4, capacity_factor=0.5)
    lp, _ = moe_inputs()
    x = np.random.default_rng(5).normal(size=(t, 16)).astype(np.float32)
    mine = {k: (v[2:4] if k.startswith("moe_") else v) for k, v in lp.items()}
    want = JL.moe_local(JConfig(**kw), {k: jnp.asarray(v)
                                        for k, v in mine.items()},
                        jnp.asarray(x), expert_lo=2, n_local_experts=2)
    stats = {}
    got = TL.moe_local(TConfig(**kw), TP.from_jax(mine, "cpu"),
                       torch.as_tensor(x), expert_lo=2, n_local_experts=2,
                       stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (int(stats["dropped"]) > 0) == (t == 40)
    full = TL.moe_local(TConfig(**kw), TP.from_jax(lp, "cpu"),
                        torch.as_tensor(x))
    other = TL.moe_local(TConfig(**kw), TP.from_jax(
        {k: (v[0:2] if k.startswith("moe_") else v) for k, v in lp.items()},
        "cpu"), torch.as_tensor(x), expert_lo=0, n_local_experts=2)
    # the two halves sum to the whole layer (each pair is one half's)
    np.testing.assert_allclose((got + other).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)


MOE_CASES = [(4, 8), (3, 8)]
# sharded serving: (mesh, arch, batch, prompt, new); the vocabulary 128
# splits over "model"; granite (one kv head) at batch 1 on (2, 2) takes
# the long-context cache spec, its sequence over data and model
SERVE_CASES = [((1, 2), "qwen2-moe-a2.7b", 2, 9, 5),
               ((2, 2), "qwen2-moe-a2.7b", 2, 9, 5),
               ((2, 2), "granite-8b", 1, 10, 6),
               ((2, 2), "jamba-1.5-large-398b", 2, 9, 5)]
SERVE_VOCAB = 128


def serve_call(case):
    """The ``serve`` rank call of ``case`` and its inputs: JAX weights of
    the smoke config at SERVE_VOCAB, numpy prompts."""
    mesh, arch, b, s, new = case
    kw = dataclasses.asdict(JR.ARCHS[arch].smoke)
    kw["vocab"] = SERVE_VOCAB
    params = np_tree(JP.init_params(JConfig(**kw), jax.random.PRNGKey(3)))
    prompts = np.random.default_rng(2).integers(0, SERVE_VOCAB, (b, s),
                                                dtype=np.int64)
    return ("serve", (mesh, kw, params, prompts, new, 7)), (kw, params,
                                                          prompts)


@pytest.fixture(scope="module")
def moe_on_two_ranks():
    """Both sharded MoE cases and the (1, 2) serving case on one spawn of
    two gloo CPU ranks, with the JAX layer's outputs."""
    calls, want = [], []
    for experts, ff in MOE_CASES:
        kw = dict(MOE_KW, moe_experts=experts, moe_ff=ff)
        lp, x = moe_inputs(experts, ff)
        want.append(np.asarray(JL.moe_layer(JConfig(**kw), {
            k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x))))
        calls.append(("moe_layer", ((1, 2), kw, lp, x)))
    serving = [c for c in SERVE_CASES if c[0] == (1, 2)]
    for case in serving:
        call, inputs = serve_call(case)
        calls.append(call)
        want.append(inputs)
    out = workers.spawn(ranks.several, 2, calls, device="cpu", timeout_s=60,
                        threads=1)
    return {case: ([r[i] for r in out], want[i])
            for i, case in enumerate(MOE_CASES + serving)}


@pytest.mark.parametrize("experts,ff", MOE_CASES)
def test_sharded_moe_on_two_ranks_equals_jax(moe_on_two_ranks, experts, ff):
    """(1, 2) gloo ranks: EP (4 experts, 2 a rank at offsets 0 and 2) and
    expert-TP (3 experts do not divide 2: ff split 4 + 4), the shared
    expert beside them, against the JAX ``moe_layer``; both ranks agree."""
    out, want = moe_on_two_ranks[(experts, ff)]
    assert out[0]["ep"] == (experts == 4)
    assert out[0]["placements"] == ("(Replicate(), Shard(dim=0))"
                                    if experts == 4 else
                                    "(Replicate(), Shard(dim=2))")
    for o in out:
        np.testing.assert_allclose(o["y"], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out[0]["y"], out[1]["y"])


FORWARD_ARCHS = ("qwen2-moe-a2.7b", "jamba-1.5-large-398b")
TRAIN_ARCH = "mixtral-8x7b"


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


BF16_ARCH = "qwen2-moe-a2.7b"


def bf16_inputs():
    """BF16_ARCH's smoke config in bfloat16 at SERVE_VOCAB, its JAX weights
    and tokens."""
    kw = dict(dataclasses.asdict(JR.ARCHS[BF16_ARCH].smoke),
              vocab=SERVE_VOCAB, dtype="bfloat16")
    params = np_tree(JP.init_params(JConfig(**kw), jax.random.PRNGKey(5)))
    tokens = np.random.default_rng(6).integers(0, SERVE_VOCAB, (4, 16),
                                               dtype=np.int32)
    return kw, params, tokens


@pytest.fixture(scope="module")
def on_a_2x2_mesh():
    """One spawn of four gloo CPU ranks, (data, model) = (2, 2): the smoke
    forwards of FORWARD_ARCHS and one TRAIN_ARCH step, with the JAX
    forwards and the JAX step at microbatches=2; the (2, 2) serving cases;
    BF16_ARCH's bfloat16 forward."""
    calls, want = [], {}
    for arch in FORWARD_ARCHS:
        cfg = JR.ARCHS[arch].smoke
        params = JP.init_params(cfg, jax.random.PRNGKey(0))
        tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 16),
                                                   dtype=np.int32)
        want[arch] = np.asarray(JM.forward(
            cfg, params, {"tokens": jnp.asarray(tokens)})[0])
        calls.append(("forward", ((2, 2), arch, np_tree(params), tokens)))
    cfg = JR.ARCHS[TRAIN_ARCH].smoke
    jopt = JAdamW(lr=1e-3)
    js = jts.init_train_state(cfg, jopt, jax.random.PRNGKey(0))
    batch = jdata.SyntheticLM(cfg, seq_len=16, global_batch=4).batch_at(0)
    want["train"] = jax.jit(jts.make_train_step(cfg, jopt, microbatches=2))(
        js, batch)
    calls.append(("train_step", ((2, 2), TRAIN_ARCH, np_tree(js),
                                 np_tree(batch), 1e-3)))
    serving = [c for c in SERVE_CASES if c[0] == (2, 2)]
    for case in serving:
        call, want[case] = serve_call(case)
        calls.append(call)
    kw, params, tokens = bf16_inputs()
    calls.append(("forward", ((2, 2), BF16_ARCH, params, tokens, kw)))
    want["bf16"] = (kw, params, tokens)
    out = workers.spawn(ranks.several, 4, calls, device="cpu",
                        timeout_s=120, threads=1)
    names = list(FORWARD_ARCHS) + ["train"] + serving + ["bf16"]
    return {n: ([r[i] for r in out], want[n]) for i, n in enumerate(names)}


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_sharded_forward_on_a_2x2_mesh_equals_jax(on_a_2x2_mesh, arch):
    """The smoke forward on FSDP + TP/EP-placed params (the MoE through
    ``make_spmd_moe``, Mamba's scan by heads) against the JAX forward;
    every rank's logits equal."""
    out, want = on_a_2x2_mesh[arch]
    for o in out:
        np.testing.assert_allclose(o["logits"], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(o["logits"], out[0]["logits"])


def test_sharded_train_step_on_a_2x2_mesh_equals_jax(on_a_2x2_mesh):
    """One mixtral smoke step (EP 4 experts a rank, FSDP over data=2) from
    the JAX state against the JAX step at microbatches=2 (each data
    shard's capacity is a microbatch's), ``test_torch_train.py``'s
    tolerances."""
    out, (js2, jm) = on_a_2x2_mesh["train"]
    o = out[0]
    np.testing.assert_allclose(o["loss"], float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(o["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-5)
    assert o["step"] == 1
    for got, want, rtol, atol in ((o["params"], js2.params, 1e-6, 1e-6),
                                  (o["m"], js2.opt.m, 1e-4, 1e-7),
                                  (o["v"], js2.opt.v, 1e-4, 1e-10)):
        g = jax.tree_util.tree_leaves(got)
        w = jax.tree_util.tree_leaves(np_tree(want))
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    for r in out[1:]:
        assert r["loss"] == o["loss"] and r["grad_norm"] == o["grad_norm"]


def test_launch_train_with_a_mesh_equals_without(capfd):
    """``launch.train.main`` with ``--mesh 1x2`` (two gloo CPU ranks,
    rank 0 printing) logs the losses of the same command without it."""
    from repro_torch.launch import train

    argv = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--seq-len", "16",
            "--global-batch", "4", "--device", "cpu", "--log-every", "1",
            "--steps", "3"]

    def losses(text):
        return [float(line.split()[3]) for line in text.splitlines()
                if line.strip().startswith("step ")]

    assert train.main(argv) == 0
    plain = losses(capfd.readouterr().out)
    assert train.main(argv + ["--mesh", "1x2"]) == 0
    out = capfd.readouterr().out
    assert "[train] mesh {'data': 1, 'model': 2} on 2 ranks (gloo, cpu)" \
        in out
    sharded = losses(out)
    assert len(plain) == len(sharded) == 3
    np.testing.assert_allclose(sharded, plain, rtol=1e-4)


def unsharded_serving(kw, params, prompts, new):
    """The unsharded port's prefill and ``new - 1`` greedy decode steps on
    the same weights: each step's logits and the tokens."""
    from repro_torch.models import model as TM
    from repro_torch.serve import decode as TD

    cfg = TConfig(**kw)
    p = TP.from_jax(params, "cpu")
    b, s = prompts.shape
    with torch.no_grad():
        cache = TM.init_cache(cfg, b, s + new, device="cpu")
        last, cache = TD.make_prefill_step(cfg)(
            p, {"tokens": torch.as_tensor(prompts)}, cache)
        tok = TD.sample(last)[:, None].to(torch.int32)
        logits, toks = [last], [tok]
        decode = TD.make_decode_step(cfg)
        for i in range(new - 1):
            tok, last, cache = decode(p, cache, tok, s + i)
            logits.append(last)
            toks.append(tok)
    return [x.numpy() for x in logits], torch.cat(toks, 1).numpy()


@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: (
    f"{c[1]}-{c[0][0]}x{c[0][1]}-b{c[2]}"))
def test_sharded_serving_equals_the_unsharded_steps(moe_on_two_ranks,
                                                   on_a_2x2_mesh, case):
    """Prefill + decode on mesh-placed params and caches: every step's
    vocabulary-split logits within 1e-4 of the unsharded port's, the
    prefill's also of the JAX forward's; the greedy tokens, ``generate``'s
    and every rank's equal; ``sample`` at temperature 0.8 on the split
    logits draws the tokens it draws from the same logits whole. The
    caches sit where ``cache_pspecs`` puts them (the long-context case:
    the sequence over data and model)."""
    fixture = moe_on_two_ranks if case[0] == (1, 2) else on_a_2x2_mesh
    out, (kw, params, prompts) = fixture[case]
    mesh, arch, b, s, new = case
    want_logits, want_tokens = unsharded_serving(kw, params, prompts, new)
    jax_last = np.asarray(JM.forward(JConfig(**kw), params, {
        "tokens": jnp.asarray(prompts)})[0])[:, -1]
    for o in out:  # the vocabulary split over "model"
        assert o["logit_placements"].endswith(", Shard(dim=1))")
        assert len(o["logits"]) == new
        for got, want in zip(o["logits"], want_logits):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["logits"][0], jax_last, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(o["tokens"], want_tokens)
        np.testing.assert_array_equal(o["generated"], want_tokens)
        np.testing.assert_array_equal(o["sampled"], o["sampled_whole"])
        np.testing.assert_array_equal(o["tokens"], out[0]["tokens"])
        np.testing.assert_array_equal(o["sampled"], out[0]["sampled"])
    kv = {k: v for k, v in out[0]["cache_placements"].items()
          if k.endswith("/k")}
    assert kv
    if arch == "granite-8b":  # batch 1 of data 2, one kv head: long context
        assert set(kv.values()) == {"(Shard(dim=2), Shard(dim=2))"}
    elif arch == "qwen2-moe-a2.7b":  # batch over data, kv heads "model"
        assert set(kv.values()) == {"(Shard(dim=1), Shard(dim=3))"}
    else:  # one kv head, batch over data: the sequence over "model"
        assert set(kv.values()) == {"(Shard(dim=1), Shard(dim=2))"}
        assert any(k.endswith("/ssm") for k in out[0]["cache_placements"])


def test_sharded_bf16_forward_is_bit_identical_to_the_unsharded_one(
        on_a_2x2_mesh):
    """BF16_ARCH in bfloat16 on (2, 2) (FSDP, EP, heads and vocabulary
    split): the logits equal the unsharded port's bit for bit, since the
    sharded products sum their float32 partials over "model" before they
    round; every rank's equal."""
    out, (kw, params, tokens) = on_a_2x2_mesh["bf16"]
    from repro_torch.models import model as TM

    with torch.no_grad():
        want, _ = TM.forward(TConfig(**kw), TP.from_jax(params, "cpu"),
                             {"tokens": torch.as_tensor(tokens)})
    want = want.numpy()
    for o in out:
        np.testing.assert_array_equal(o["logits"].astype(np.float32), want)
