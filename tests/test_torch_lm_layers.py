"""The port's LM config, registry and layers (``repro_torch.models``,
``repro_torch.configs``) against the JAX package's: every registry config
field by field, the parameter specs of the ten full configs, and each
layer function on the same numpy inputs (float32, rtol 1e-4 / atol 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import layers as JL, mamba as JMB, params as JP
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL, mamba as TMB, params as TP
from repro_torch.models.config import ModelConfig as TConfig

ARCHS = list(JR.ARCHS)
RTOL, ATOL = 1e-4, 1e-5
# the JAX functions compiled whole (op-by-op dispatch compiles every op)
J_ATTENTION = jax.jit(JL.attention, static_argnums=0)
J_MOE_LOCAL = jax.jit(JL.moe_local, static_argnums=0)
J_MOE_LAYER = jax.jit(JL.moe_layer, static_argnums=0)
J_SSD = jax.jit(JMB.ssd_chunked, static_argnums=5)
J_MAMBA_FORWARD = jax.jit(JMB.mamba_forward, static_argnums=0,
                          static_argnames="chunk")
J_MAMBA_DECODE = jax.jit(JMB.mamba_decode, static_argnums=0)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def both(a):
    """One numpy array as (jnp, torch) operands."""
    return jnp.asarray(a), torch.as_tensor(np.asarray(a))


def lp_pair(rng, shapes, scale=0.3):
    """Random float32 layer params as (jax dict, torch dict)."""
    raw = {k: (scale * rng.normal(size=s)).astype(np.float32)
           for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.as_tensor(v) for k, v in raw.items()})


def tcfg_of(cfg: JConfig, **over) -> TConfig:
    return TConfig(**dict(dataclasses.asdict(cfg), **over))


# -- config and registry ------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_registry_config_equals_jax(arch, which):
    j = getattr(JR.ARCHS[arch], which)
    t = getattr(TR.ARCHS[arch], which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.layer_kinds() == j.layer_kinds()
    assert t.block_pattern() == j.block_pattern()
    assert (t.n_blocks, t.hd, t.d_inner, t.ssm_heads) == (
        j.n_blocks, j.hd, j.d_inner, j.ssm_heads)
    assert t.num_params() == j.num_params()
    assert t.active_params() == j.active_params()
    assert t.sub_quadratic() == j.sub_quadratic()
    assert (TR.ARCHS[arch].train_microbatches
            == JR.ARCHS[arch].train_microbatches)


def test_cells_and_shape_applicability_equal_jax():
    from repro.configs import shapes as JS
    from repro_torch.configs import shapes as TS
    assert ({k: dataclasses.asdict(v) for k, v in TS.ALL_SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in JS.ALL_SHAPES.items()})
    for inc in (False, True):
        got = [(a, s.name, r) for a, s, r in TR.cells(inc)]
        want = [(a, s.name, r) for a, s, r in JR.cells(inc)]
        assert got == want
    assert len(TR.cells(True)) == 40
    for arch in ARCHS:
        for name in JS.ALL_SHAPES:
            assert (TR.shape_applicable(arch, TS.ALL_SHAPES[name])
                    == JR.shape_applicable(arch, JS.ALL_SHAPES[name]))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_of_full_configs_equal_jax(arch):
    """Shapes on ``meta`` (nothing allocated) equal the JAX specs, path for
    path; their element count is the analytic ``num_params``."""
    cfg = TR.ARCHS[arch].config
    got = TP.param_specs(cfg)
    want = JP.param_specs(JR.ARCHS[arch].config)
    flat_got = TP.tree_leaves(got)
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in flat_got)
    assert (TP.tree_map(lambda t: tuple(t.shape), got)
            == jax.tree_util.tree_map(lambda s: tuple(s.shape), want))
    assert sum(t.numel() for t in flat_got) == cfg.num_params()
    axes = TP.param_axes(cfg)
    want_axes = JP.param_axes(JR.ARCHS[arch].config)
    assert TP.tree_map(lambda a: a, axes) == want_axes
    assert TP.tree_map(lambda t: t.dim(), got) == TP.tree_map(len, axes)


# -- norms, positions, rope, mask ---------------------------------------------

def test_rms_norm_and_sinusoidal_equal_jax():
    rng = np.random.default_rng(0)
    jx, tx = both(rng.normal(size=(2, 5, 24)).astype(np.float32))
    jw, tw = both(rng.normal(size=(24,)).astype(np.float32))
    close(TL.rms_norm(tx, tw, 1e-5), JL.rms_norm(jx, jw, 1e-5))
    pos = np.arange(37)
    close(TL.sinusoidal_pos(torch.as_tensor(pos), 64, torch.float32),
          JL.sinusoidal_pos(jnp.asarray(pos), 64, jnp.float32))


@pytest.mark.parametrize("mode", ["standard", "2d", "none"])
def test_rope_equals_jax(mode):
    rng = np.random.default_rng(1)
    jx, tx = both(rng.normal(size=(2, 7, 3, 16)).astype(np.float32))
    pos = np.arange(3, 10)
    rot = 16 if mode == "standard" else 8
    jc, js = JL.rope_tables(jnp.asarray(pos), rot, 10_000.0)
    tc, ts = TL.rope_tables(torch.as_tensor(pos), rot, 10_000.0)
    close(tc, jc)
    close(ts, js)
    close(TL.apply_rope(tx, tc[None], ts[None], mode),
          JL.apply_rope(jx, jc[None], js[None], mode))


@pytest.mark.parametrize("window", [0, 3])
def test_attention_mask_equals_jax(window):
    q = np.arange(4, 9)
    k = np.arange(-2, 9)
    got = TL._attn_scores_mask(torch.as_tensor(q), torch.as_tensor(k), window)
    want = JL._attn_scores_mask(jnp.asarray(q), jnp.asarray(k), window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- attention ----------------------------------------------------------------

def _attn_setup(window, qkv_bias, rope="standard", seed=0):
    cfg = JConfig("a", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                  d_ff=0, vocab=7, head_dim=8, attn_window=window,
                  qkv_bias=qkv_bias, rope=rope, dtype="float32")
    d, hq, hkv, hd = 32, 4, 2, 8
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    if qkv_bias:
        shapes.update(bq=(hq * hd,), bk=(hkv * hd,), bv=(hkv * hd,))
    jlp, tlp = lp_pair(np.random.default_rng(seed), shapes)
    return cfg, tcfg_of(cfg), jlp, tlp


# (window, qkv_bias, rope): full, sliding window, QKV bias, partial rotary
ATTN_CASES = [(0, False, "standard"), (0, True, "2d"), (5, False, "standard"),
              (5, True, "none")]


@pytest.mark.parametrize("window,qkv_bias,rope", ATTN_CASES)
def test_attention_train_equals_jax(window, qkv_bias, rope):
    cfg, tcfg, jlp, tlp = _attn_setup(window, qkv_bias, rope)
    jx, tx = both(np.random.default_rng(2).normal(size=(2, 11, 32))
                  .astype(np.float32))
    want, _ = J_ATTENTION(cfg, jlp, jx, positions=jnp.arange(11))
    got, cache = TL.attention(tcfg, tlp, tx, positions=torch.arange(11))
    assert cache is None
    close(got, want)


@pytest.mark.parametrize("window,qkv_bias,rope", ATTN_CASES)
@pytest.mark.parametrize("s", [6, 13])
def test_attention_prefill_then_decode_equals_jax(window, qkv_bias, rope, s):
    """Prefill s tokens into a cache of s + 3 slots (a ring of ``window``
    slots under a window; s = 13 > 5 takes the ring prefill), then three
    decode steps: outputs and the cache after every step."""
    cfg, tcfg, jlp, tlp = _attn_setup(window, qkv_bias, rope, seed=3)
    x = np.random.default_rng(4).normal(size=(2, s + 3, 32)).astype(np.float32)
    s_kv = min(s + 3, window) if window else s + 3
    jc = {"k": jnp.zeros((2, s_kv, 2, 8)), "v": jnp.zeros((2, s_kv, 2, 8))}
    tc = {"k": torch.zeros(2, s_kv, 2, 8), "v": torch.zeros(2, s_kv, 2, 8)}
    want, jc = J_ATTENTION(cfg, jlp, jnp.asarray(x[:, :s]),
                            positions=jnp.arange(s), cache=jc)
    got, tc2 = TL.attention(tcfg, tlp, torch.as_tensor(x[:, :s]),
                            positions=torch.arange(s), cache=tc)
    assert tc2 is tc  # written in place
    close(got, want)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    for i in range(3):
        pos = s + i
        want, jc = J_ATTENTION(cfg, jlp, jnp.asarray(x[:, pos:pos + 1]),
                                positions=jnp.asarray([pos]), cache=jc,
                                cache_pos=jnp.asarray(pos))
        got, _ = TL.attention(tcfg, tlp, torch.as_tensor(x[:, pos:pos + 1]),
                              positions=torch.tensor([pos]), cache=tc,
                              cache_pos=pos)
        close(got, want)
        close(tc["k"], jc["k"])
        close(tc["v"], jc["v"])


def test_attention_cache_write_past_the_end_raises():
    """The JAX ``dynamic_update_slice`` clamps such a write; the port
    refuses it."""
    _, tcfg, _, tlp = _attn_setup(0, False)
    tc = {"k": torch.zeros(1, 4, 2, 8), "v": torch.zeros(1, 4, 2, 8)}
    with pytest.raises(ValueError, match="cache of 4 slots"):
        TL.attention(tcfg, tlp, torch.zeros(1, 1, 32),
                     positions=torch.tensor([4]), cache=tc, cache_pos=4)
    with pytest.raises(ValueError, match="cache of 4 slots"):
        TL.attention(tcfg, tlp, torch.zeros(1, 5, 32),
                     positions=torch.arange(5), cache=tc)


# -- MLPs and MoE -------------------------------------------------------------

@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_dense_mlp_equals_jax(activation):
    cfg = JConfig("m", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                  d_ff=24, vocab=7, activation=activation, dtype="float32")
    jlp, tlp = lp_pair(np.random.default_rng(5),
                       {"w1": (16, 24), "w2": (24, 16), "w3": (16, 24)}, 0.5)
    jx, tx = both(np.random.default_rng(6).normal(size=(3, 4, 16))
                  .astype(np.float32))
    close(TL.dense_mlp(tcfg_of(cfg), tlp["w1"], tlp["w2"], tlp["w3"], tx),
          JL.dense_mlp(cfg, jlp["w1"], jlp["w2"], jlp["w3"], jx))


def _moe_setup(e, k, cf, activation="swiglu", shared=0, seed=7, d=16, ff=8):
    cfg = JConfig("m", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2,
                  d_ff=0, vocab=11, moe_experts=e, moe_top_k=k, moe_ff=ff,
                  moe_shared_ff=shared, capacity_factor=cf,
                  activation=activation, dtype="float32")
    shapes = {"router": (d, e), "moe_w1": (e, d, ff), "moe_w2": (e, ff, d),
              "moe_w3": (e, d, ff)}
    if shared:
        shapes.update(shared_w1=(d, shared), shared_w2=(shared, d),
                      shared_w3=(d, shared), shared_gate=(d, 1))
    jlp, tlp = lp_pair(np.random.default_rng(seed), shapes, 0.5)
    return cfg, tcfg_of(cfg), jlp, tlp


# (experts, top-k, capacity factor, tokens, activation): no drops, drops at
# a small capacity factor (the stable sort decides which), t <= E (cap = t)
MOE_CASES = [(4, 2, 8.0, 24, "swiglu"), (4, 2, 0.5, 40, "swiglu"),
             (8, 2, 0.25, 64, "gelu"), (6, 3, 1.0, 30, "swiglu"),
             (8, 2, 0.25, 8, "swiglu")]


@pytest.mark.parametrize("e,k,cf,t,activation", MOE_CASES)
def test_moe_local_equals_jax(e, k, cf, t, activation):
    cfg, tcfg, jlp, tlp = _moe_setup(e, k, cf, activation)
    jx, tx = both(np.random.default_rng(8).normal(size=(t, 16))
                  .astype(np.float32))
    stats = {}
    got = TL.moe_local(tcfg, tlp, tx, stats=stats)
    close(got, J_MOE_LOCAL(cfg, jlp, jx))
    cap = t if t <= e else int(np.ceil(t * k / e * cf))
    if cf < 1.0 and t > e:
        assert int(stats["dropped"]) > 0
    assert int(stats["dropped"]) >= max(0, t * k - e * cap)


def test_moe_local_ties_go_to_the_lower_expert():
    """Equal router logits: ``lax.top_k`` picks the lower index; the port
    keeps that rule (a stable descending sort)."""
    cfg, tcfg, jlp, tlp = _moe_setup(4, 2, 8.0)
    tlp = dict(tlp, router=torch.zeros(16, 4))
    jlp = dict(jlp, router=jnp.zeros((16, 4)))
    x = np.random.default_rng(9).normal(size=(10, 16)).astype(np.float32)
    vals, idx = TL._top_k(torch.zeros(10, 4), 2)
    assert idx.tolist() == [[0, 1]] * 10
    close(TL.moe_local(tcfg, tlp, torch.as_tensor(x)),
          J_MOE_LOCAL(cfg, jlp, jnp.asarray(x)))


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_layer_with_shared_experts_equals_jax(cf):
    cfg, tcfg, jlp, tlp = _moe_setup(4, 2, cf, shared=16, seed=10)
    jx, tx = both(np.random.default_rng(11).normal(size=(2, 9, 16))
                  .astype(np.float32))
    close(TL.moe_layer(tcfg, tlp, tx), J_MOE_LAYER(cfg, jlp, jx))


# -- Mamba2 / SSD -------------------------------------------------------------

def test_segsum_and_causal_conv_equal_jax():
    rng = np.random.default_rng(12)
    ja, ta = both(rng.normal(size=(2, 3, 6)).astype(np.float32))
    np.testing.assert_allclose(TMB._segsum(ta).numpy(),
                               np.asarray(JMB._segsum(ja)), rtol=RTOL,
                               atol=ATOL)
    jx, tx = both(rng.normal(size=(2, 7, 5)).astype(np.float32))
    jw, tw = both(rng.normal(size=(4, 5)).astype(np.float32))
    jy, jst = JMB._causal_conv(jx, jw)
    ty, tst = TMB._causal_conv(tx, tw)
    close(ty, jy)
    close(tst, jst)
    # continuation from a state (the decode path)
    jx2, tx2 = both(rng.normal(size=(2, 1, 5)).astype(np.float32))
    jy2, jst2 = JMB._causal_conv(jx2, jw, jst)
    ty2, tst2 = TMB._causal_conv(tx2, tw, tst)
    close(ty2, jy2)
    close(tst2, jst2)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_equals_jax(chunk):
    rng = np.random.default_rng(13)
    b, s, h, p, n = 2, 64, 3, 4, 8
    args = [rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.1, (b, s, h)),
            -rng.uniform(0.5, 2.0, (h,)), rng.normal(size=(b, s, n)),
            rng.normal(size=(b, s, n))]
    args = [a.astype(np.float32) for a in args]
    init = rng.normal(size=(b, h, p, n)).astype(np.float32)
    for st0 in (None, init):
        jy, jfin = J_SSD(*map(jnp.asarray, args), chunk,
                         None if st0 is None else jnp.asarray(st0))
        ty, tfin = TMB.ssd_chunked(*map(torch.as_tensor, args), chunk,
                                   None if st0 is None else torch.as_tensor(st0))
        close(ty, jy)
        close(tfin, jfin)


def _mamba_setup(seed=14):
    cfg = JConfig("s", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                  d_ff=0, vocab=7, ssm=True, ssm_state=8, ssm_head_dim=4,
                  ssm_expand=2, ssm_conv=4, dtype="float32")
    d, din, n, h = 16, 32, 8, 8
    rng = np.random.default_rng(seed)
    shapes = {"wz": (d, din), "wx": (d, din), "wb": (d, n), "wc": (d, n),
              "wdt": (d, h), "conv_x": (4, din), "conv_b": (4, n),
              "conv_c": (4, n), "D": (h,), "ssm_norm": (din,),
              "out_proj": (din, d)}
    jlp, tlp = lp_pair(rng, shapes)
    extra = {"dt_bias": rng.uniform(-4, -1, (h,)).astype(np.float32),
             "A_log": np.log(rng.uniform(1, 16, (h,))).astype(np.float32)}
    jlp.update({k: jnp.asarray(v) for k, v in extra.items()})
    tlp.update({k: torch.as_tensor(v) for k, v in extra.items()})
    return cfg, tcfg_of(cfg), jlp, tlp


def _mamba_cache(b, cfg):
    return {"ssm": np.zeros((b, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state), np.float32),
            "conv_x": np.zeros((b, 3, cfg.d_inner), np.float32),
            "conv_b": np.zeros((b, 3, cfg.ssm_state), np.float32),
            "conv_c": np.zeros((b, 3, cfg.ssm_state), np.float32)}


@pytest.mark.parametrize("s,chunk", [(16, 8), (13, 8), (5, 16)])
def test_mamba_forward_and_decode_equal_jax(s, chunk):
    """Full-sequence block (s not a multiple of the chunk: the zero
    padding), its cache, then three decode steps and their caches."""
    cfg, tcfg, jlp, tlp = _mamba_setup()
    x = np.random.default_rng(15).normal(size=(2, s + 3, 16)).astype(np.float32)
    zero = _mamba_cache(2, cfg)
    jc = {k: jnp.asarray(v) for k, v in zero.items()}
    tc = {k: torch.as_tensor(v) for k, v in zero.items()}
    want, jc = J_MAMBA_FORWARD(cfg, jlp, jnp.asarray(x[:, :s]), cache=jc,
                                 chunk=chunk)
    got, tc2 = TMB.mamba_forward(tcfg, tlp, torch.as_tensor(x[:, :s]),
                                 cache=tc, chunk=chunk)
    assert tc2 is tc
    close(got, want)
    for key in zero:
        close(tc[key], jc[key])
    for i in range(3):
        xs = x[:, s + i:s + i + 1]
        want, jc = J_MAMBA_DECODE(cfg, jlp, jnp.asarray(xs), jc)
        got, _ = TMB.mamba_decode(tcfg, tlp, torch.as_tensor(xs), tc)
        close(got, want)
        for key in zero:
            close(tc[key], jc[key])
