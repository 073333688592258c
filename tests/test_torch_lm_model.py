"""The port's decoder stack (``repro_torch.models.model``) against the JAX
package's: ``forward`` of all ten registry smoke configs (float32, rtol /
atol 1e-4; one bfloat16 case at 3e-2), prefill plus KV-cache decode step
by step, ``init_params``, ``from_jax`` and the ``Model`` module. The JAX
parameters are carried across with ``from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import model as JM, params as JP
from repro.serve import decode as JD
from repro_torch.configs import registry as TR
from repro_torch.models import model as TM, params as TP
from repro_torch.serve import decode as TD

ARCHS = list(JR.ARCHS)
# the five architectures of test_configs_smoke's decode test
DECODE_ARCHS = ["chatglm3-6b", "mixtral-8x7b", "mamba2-130m",
                "jamba-1.5-large-398b", "qwen2-moe-a2.7b"]
J_FORWARD = jax.jit(JM.forward, static_argnums=0,
                    static_argnames=("remat", "unroll", "logits_f32"))


def flat(tree, prefix=()):
    """{path: leaf} of a tree of nested dicts (torch or JAX leaves)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def carried(jparams):
    return TP.from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def setup(arch, seed=0):
    jcfg, tcfg = JR.ARCHS[arch].smoke, TR.ARCHS[arch].smoke
    jp = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, carried(jp)


def batches(cfg, b, s, seed=1):
    """A (jax, torch) batch as the JAX data pipeline shapes it: embeddings
    in place of tokens for audio frames, patch embeddings before the
    tokens for vision patches."""
    rng = np.random.default_rng(seed)
    raw = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "audio_frames":
        raw = {"embeds": (0.02 * rng.normal(size=(b, s, cfg.d_model)))
               .astype(np.float32)}
    elif cfg.frontend == "vision_patches":
        raw["embeds"] = (0.02 * rng.normal(
            size=(b, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.as_tensor(v) for k, v in raw.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_jax(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    jb, tb = batches(jcfg, 2, 16)
    want, _ = J_FORWARD(jcfg, jp, jb)
    got, cache = TM.forward(tcfg, tp, tb)
    s = 16 + (jcfg.frontend_tokens if jcfg.frontend == "vision_patches" else 0)
    assert cache is None and got.shape == (2, s, jcfg.vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_forward_bfloat16_follows_the_cast_rule():
    """granite smoke in bfloat16: every leaf with ndim >= 2 (the stacked
    norm weights included) cast to bfloat16, ``final_norm`` kept float32,
    as the JAX forward casts."""
    arch = "granite-8b"
    jcfg = dataclasses.replace(JR.ARCHS[arch].smoke, dtype="bfloat16")
    tcfg = dataclasses.replace(TR.ARCHS[arch].smoke, dtype="bfloat16")
    jp = JP.init_params(jcfg, jax.random.PRNGKey(3))
    tp = carried(jp)
    cast = TM._cast_params(tp, torch.bfloat16)
    assert cast["final_norm"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16
               for t in TP.tree_leaves(cast["blocks"]))
    jb, tb = batches(jcfg, 2, 12, seed=4)
    want, _ = J_FORWARD(jcfg, jp, jb)
    got, _ = TM.forward(tcfg, tp, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2,
                               atol=3e-2)
    low, _ = TM.forward(tcfg, tp, tb, logits_f32=False)
    assert low.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_equal_jax_step_by_step(arch):
    """Prefill 12 tokens (mixtral's window is 8: the ring prefill), then
    four decode steps fed the same tokens: the logits and the caches of
    every step equal the JAX package's, and each decode step equals the
    full forward at its position."""
    jcfg, tcfg, jp, tp = setup(arch)
    s, steps = 12, 4
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (2, s + steps)).astype(np.int32)
    jpre = jax.jit(JD.make_prefill_step(jcfg))
    jdec = jax.jit(JD.make_decode_step(jcfg))
    jc = JM.init_cache(jcfg, 2, s + steps)
    tc = TM.init_cache(tcfg, 2, s + steps, device="cpu")
    assert (TP.tree_map(lambda t: (tuple(t.shape), str(t.dtype)), tc)
            == jax.tree_util.tree_map(
                lambda a: (tuple(a.shape), "torch." + str(a.dtype)), jc))
    jlast, jc = jpre(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc)
    tlast, tc2 = TD.make_prefill_step(tcfg)(
        tp, {"tokens": torch.as_tensor(toks[:, :s])}, tc)
    assert tc2 is tc
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    full, _ = TM.forward(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    tdec = TD.make_decode_step(tcfg)
    for i in range(steps):
        pos = s + i
        tok = toks[:, pos:pos + 1]
        _, jlog, jc = jdec(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                           jax.random.PRNGKey(0))
        _, tlog, _ = tdec(tp, tc, torch.as_tensor(tok), pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
        want_cache = flat(jc)
        for path, got in flat(tc).items():
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(want_cache[path]),
                                       rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tlog.numpy(), full[:, pos].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_remat_and_unroll_forward_identical():
    jcfg, tcfg, jp, tp = setup("granite-8b", seed=5)
    _, tb = batches(jcfg, 2, 8)
    base, _ = TM.forward(tcfg, tp, tb)
    for kw in ({"remat": True}, {"unroll": True},
               {"remat": True, "unroll": True}):
        out, _ = TM.forward(tcfg, tp, tb, **kw)
        assert torch.equal(out, base)


def test_remat_gradients_equal_plain_gradients():
    _, tcfg, _, tp = setup("mixtral-8x7b", seed=6)
    _, tb = batches(tcfg, 2, 8)
    grads = []
    for remat in (False, True):
        m = TM.Model(tcfg, TP.tree_map(lambda t: t.clone(), tp))
        logits, _ = m(tb, remat=remat)
        logits.square().mean().backward()
        grads.append([p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_model_module_holds_the_tree_under_the_jax_paths():
    jcfg, tcfg, jp, tp = setup("qwen2-moe-a2.7b", seed=7)
    m = TM.Model(tcfg, tp)
    names = {n for n, _ in m.named_parameters()}
    want = {"params." + ".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert names == want
    assert all(a is b or a.data_ptr() == b.data_ptr() for a, b in zip(
        TP.tree_leaves(m.tree()), TP.tree_leaves(tp)))
    _, tb = batches(jcfg, 2, 6)
    with torch.no_grad():
        got, _ = m(tb)
    want_logits, _ = TM.forward(tcfg, tp, tb)
    assert torch.equal(got, want_logits)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen2-moe-a2.7b",
                                  "musicgen-medium"])
def test_init_params_has_the_jax_shapes_dtypes_and_ranges(arch):
    jcfg, tcfg = JR.ARCHS[arch].smoke, TR.ARCHS[arch].smoke
    want = JP.init_params(jcfg, jax.random.PRNGKey(0))
    for dtype in (torch.float32, torch.bfloat16):
        got = TP.init_params(tcfg, torch.Generator().manual_seed(0),
                             dtype=dtype, device="cpu")
        assert (TP.tree_map(lambda t: tuple(t.shape), got)
                == jax.tree_util.tree_map(lambda a: tuple(a.shape), want))
        assert all(t.dtype == dtype and t.device.type == "cpu"
                   for t in TP.tree_leaves(got))
    got = TP.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    again = TP.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(TP.tree_leaves(got),
                                                 TP.tree_leaves(again)))
    want = flat(want)
    for path, leaf in flat(got).items():
        name = path[-1]
        j, t = np.asarray(want[path]), leaf.numpy()
        if name in ("final_norm", "norm_mixer", "norm_mlp", "D", "ssm_norm"):
            assert (t == 1).all() and (j == 1).all()
        elif name in ("bq", "bk", "bv"):
            assert (t == 0).all() and (j == 0).all()
        elif name == "A_log":
            assert t.min() >= 0 and t.max() < np.log(16) + 1e-6
        elif name == "dt_bias":
            dt = np.logaddexp(t, 0)
            assert dt.min() >= 1e-3 - 1e-7 and dt.max() <= 1e-1 + 1e-6
        else:  # normal draws: the same scale as the JAX draw
            assert abs(t.std() / j.std() - 1) < 0.2, name
            assert abs(t.mean()) < 4 * j.std() / np.sqrt(t.size) + 1e-3


def test_from_jax_carries_bfloat16_bits():
    a = jnp.asarray(np.random.default_rng(8).normal(size=(3, 5)),
                    jnp.bfloat16)
    t = TP.from_jax({"x": {"y": np.asarray(a)}}, "cpu")["x"]["y"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(), np.asarray(a).view(np.int16))
    f = TP.from_jax({"x": np.asarray(a)}, "cpu", dtype=torch.float32)["x"]
    np.testing.assert_array_equal(f.numpy(), np.asarray(a, np.float32))


def test_entry_points_default_to_the_card():
    """``init_params`` and ``init_cache`` go to the CUDA device unless
    told otherwise; without CUDA they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default is the card")
    cfg = TR.ARCHS["granite-8b"].smoke
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_cache(cfg, 1, 8)
    assert TM.cache_specs(cfg, 1, 8)["l0"]["k"].device.type == "meta"


def test_sinusoidal_decode_takes_its_own_position():
    """ROADMAP fault 10: the JAX ``embed_input`` adds position 0's
    sinusoid to every decode step (musicgen), so its decode leaves its own
    full forward; the port adds the sinusoid of ``cache_pos`` and its
    decode equals the full forward. Prefill equals the JAX prefill."""
    jcfg, tcfg, jp, tp = setup("musicgen-medium", seed=9)
    s = 8
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab, (2, s + 1)).astype(np.int32)
    jfull, _ = J_FORWARD(jcfg, jp, {"tokens": jnp.asarray(toks)})
    jc = JM.init_cache(jcfg, 2, s + 1)
    jlast, jc = jax.jit(JD.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks[:, :s])}, jc)
    _, jlog, _ = jax.jit(JD.make_decode_step(jcfg))(
        jp, jc, jnp.asarray(toks[:, s:]), jnp.asarray(s),
        jax.random.PRNGKey(0))
    assert np.abs(np.asarray(jlog) - np.asarray(jfull[:, s])).max() > 0.1
    tc = TM.init_cache(tcfg, 2, s + 1, device="cpu")
    tlast, _ = TD.make_prefill_step(tcfg)(
        tp, {"tokens": torch.as_tensor(toks[:, :s])}, tc)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    _, tlog, _ = TD.make_decode_step(tcfg)(tp, tc, torch.as_tensor(
        toks[:, s:]), s)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jfull[:, s]),
                               rtol=1e-4, atol=1e-4)
