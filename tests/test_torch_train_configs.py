"""Training all ten registry smoke configs in the port against the JAX
package, the counterpart of tests/test_configs_smoke.py's
``test_one_train_step``: the loss and every gradient against
``jax.value_and_grad`` of the JAX loss (remat on, as the train step runs
it), and one whole step against the JAX ``make_train_step`` from the same
state and batch (the JAX data pipeline's batch, carried across as numpy).

Tolerances: float32 throughout. The loss within rtol 1e-5; each gradient
leaf within 1e-4 of its own largest magnitude plus rtol 1e-3 (float32
sums over batch, sequence and experts in another order; a leaf's small
entries are its largest's rounding noise). The whole step: loss and
grad_norm within rtol 1e-5, and the parameters within 2e-6 of the
1e-5-sized first update (lr 1e-3 over 100 warm-up steps), which a
gradient that flipped sign would miss by 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.train import data as jdata
from repro.train import train_step as jts
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import registry as TR
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as tts
from repro_torch.train.optimizer import AdamW as TAdamW

ARCHS = list(JR.ARCHS)


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
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def setup(arch, seed=0):
    jcfg, tcfg = JR.ARCHS[arch].smoke, TR.ARCHS[arch].smoke
    state = jts.init_train_state(jcfg, JAdamW(lr=1e-3),
                                 jax.random.PRNGKey(seed))
    batch = jdata.SyntheticLM(jcfg, seq_len=16, global_batch=2,
                              seed=seed).batch_at(0)
    return jcfg, tcfg, state, batch


def carried(state):
    return tts.from_jax(jax.tree_util.tree_map(np.asarray, state), "cpu")


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_jax(arch):
    jcfg, tcfg, js, batch = setup(arch)
    vg = jax.jit(jax.value_and_grad(jts.make_loss_fn(jcfg, remat=True)))
    want_loss, want = vg(js.params, batch)
    params = carried(js).params
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tts.make_loss_fn(tcfg, remat=True)(params, torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = flat(params)
    for k, w in flat(want).items():
        w = np.asarray(w)
        g = got[k].grad
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_equals_jax(arch):
    """Finite loss and grad_norm, parameters moved (the JAX smoke test's
    checks), and the step equal to the JAX step."""
    jcfg, tcfg, js, batch = setup(arch)
    js2, jm = jax.jit(jts.make_train_step(jcfg, JAdamW(lr=1e-3),
                                          microbatches=1, remat=True))(
        js, batch)
    ts0 = carried(js)
    before = {k: v.clone() for k, v in flat(ts0.params).items()}
    ts2, tm = tts.make_train_step(tcfg, TAdamW(lr=1e-3), microbatches=1,
                                  remat=True)(ts0, torch_batch(batch))
    assert np.isfinite(float(tm["loss"])) and np.isfinite(
        float(tm["grad_norm"]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    after = flat(ts2.params)
    assert any(not torch.equal(after[k], before[k]) for k in before)
    for k, w in flat(js2.params).items():
        np.testing.assert_allclose(after[k].numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6, err_msg=f"{arch} {k}")
