"""The port's LM serving path (``repro_torch.serve.decode``,
``python -m repro_torch.serve_lm``) against the JAX package's: greedy
``generate`` gives the JAX tokens exactly; sampling repeats from one
generator seed and follows the softmax; prefill plus decode equals the
full forward for every registry smoke config."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import params as JP
from repro.serve import decode as JD
from repro_torch import serve_lm
from repro_torch.configs import registry as TR
from repro_torch.models import model as TM, params as TP
from repro_torch.serve import decode as TD

ARCHS = list(TR.ARCHS)


def carried(jparams):
    return TP.from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "granite-8b",
                                  "mamba2-130m"])
def test_greedy_generate_equals_jax_tokens(arch):
    """Prompts of 10 tokens and 8 new ones: mixtral's window of 8 takes
    the ring prefill and wraps its ring in decode; MoE routes every
    step."""
    jcfg, tcfg = JR.ARCHS[arch].smoke, TR.ARCHS[arch].smoke
    jp = JP.init_params(jcfg, jax.random.PRNGKey(11))
    prompts = np.random.default_rng(12).integers(
        0, jcfg.vocab, (3, 10)).astype(np.int32)
    want = np.asarray(JD.generate(jcfg, jp, jnp.asarray(prompts), max_new=8))
    got = TD.generate(tcfg, carried(jp), torch.as_tensor(prompts), max_new=8)
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def _smoke(arch, seed=0):
    cfg = TR.ARCHS[arch].smoke
    return cfg, TP.init_params(cfg, torch.Generator().manual_seed(seed),
                               device="cpu")


def test_sampled_generate_repeats_from_one_seed():
    cfg, params = _smoke("qwen2-moe-a2.7b")
    prompts = torch.randint(0, cfg.vocab, (4, 6),
                            generator=torch.Generator().manual_seed(1))

    def sample(seed, temperature=0.8):
        return TD.generate(cfg, params, prompts, 10, temperature=temperature,
                           generator=torch.Generator().manual_seed(seed))
    a, b, c = sample(5), sample(5), sample(6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(TD.generate(cfg, params, prompts, 10, temperature=0.8),
                       sample(0))
    # a vanishing temperature is greedy
    assert torch.equal(sample(7, 1e-6), TD.generate(cfg, params, prompts, 10))


def test_sampling_draws_from_the_tempered_softmax():
    """The Gumbel-max draw of ``jax.random.categorical``: frequencies of
    many draws against softmax(logits / T)."""
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0, 0.5]]).repeat(20_000, 1)
    g = torch.Generator().manual_seed(0)
    picks = TD._pick(logits, 0.7, g)
    freq = torch.bincount(picks, minlength=5).double() / picks.numel()
    want = torch.softmax(logits[0].double() / 0.7, dim=0)
    assert torch.allclose(freq, want, atol=0.012)
    assert torch.equal(TD._pick(logits[:3], 0.0, g), torch.tensor([3, 3, 3]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_full_forward(arch):
    """Every smoke config (the card's LM check at CPU size): prefill 9
    tokens, decode 4 more; each step's logits equal the full forward's at
    its position within 2e-3, and the prefill's last logits equal the
    full forward of the prefix bit for bit."""
    cfg, params = _smoke(arch, seed=2)
    toks = torch.randint(0, cfg.vocab, (2, 13),
                         generator=torch.Generator().manual_seed(3))
    full, _ = TM.forward(cfg, params, {"tokens": toks})
    prefix, _ = TM.forward(cfg, params, {"tokens": toks[:, :9]})
    cache = TM.init_cache(cfg, 2, 13, device="cpu")
    last, cache = TD.make_prefill_step(cfg)(params, {"tokens": toks[:, :9]},
                                            cache)
    assert torch.equal(last, prefix[:, -1])
    step = TD.make_decode_step(cfg)
    for pos in range(9, 13):
        nxt, logits, cache = step(params, cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(logits, full[:, pos], rtol=2e-3, atol=2e-3)
        assert torch.equal(nxt[:, 0], torch.argmax(logits, -1).int())


def test_generate_refuses_a_cache_overrun():
    cfg, params = _smoke("granite-8b")
    step = TD.make_decode_step(cfg)
    cache = TM.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="cache of 4 slots"):
        step(params, cache, torch.zeros(1, 1, dtype=torch.long), 4)


def test_serve_lm_runs_on_the_cpu_when_asked(capsys):
    assert serve_lm.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "serving mixtral-8x7b-smoke on cpu" in out
    assert "greedy: 4 requests x 16 new tokens" in out
    assert "sampled:" in out
    for b in (1, 8, 32):
        assert f"batch {b:3d}:" in out


def test_serve_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.main(["--arch", "granite-8b"])
