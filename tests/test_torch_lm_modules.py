"""The LM modules new to the port since Zamba2, each against the JAX
package's function on the same weights and inputs (float32, numpy inputs
from a seed), within rtol=atol=1e-5:

* ``moe.moe_apply`` in both dispatch modes (one-hot einsums, gather), at
  the config's capacity and at a capacity factor that drops tokens; the
  routing's ``keep`` mask, experts and slots exactly equal JAX's;
* MLA self-attention (causal, and windowed) and cached MLA decode;
* cross attention (non-causal, S != T: kernel 7's plain version);
* M-RoPE, the nonparametric LayerNorm and the GELU MLP;
* sliding-window decode at pos < w, pos >= w and w >= S (the whole
  cache), and windowed self-attention (kernel 7's plain version with a
  window) against JAX's masked jnp attention, with its windowed
  ``flash_attention_plain`` against JAX's ``_sdpa`` on the same mask;
* the MoE block with MLA, and its cached decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import blocks as j_blocks  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import mla as j_mla  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402,E501
from repro_torch.models import attention, blocks, layers, lm, mla, moe  # noqa: E402,E501
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _p(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


def _cfgs(arch, **changes):
    return (dataclasses.replace(j_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -------------------------------------------------------------------- MoE --
def _jax_routing(params, cfg, xg):
    """``repro.models.moe.moe_apply``'s routing lines (:49-71): top_i,
    slot and keep."""
    g, tg, _ = xg.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ params["router"], -1)
    _, top_i = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(top_i, e, dtype=jnp.int32)
    pos = jnp.cumsum(sel.reshape(g, tg * k, e), axis=1) - 1
    slot = jnp.sum(pos.reshape(g, tg, k, e) * sel, axis=-1)
    return top_i, slot, slot < j_moe._capacity(cfg, tg)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v2_236b"])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_apply_matches_jax(arch, dispatch, capacity_factor):
    changes = {"moe_dispatch": dispatch, "moe_group_size": 16}
    if capacity_factor:
        changes["capacity_factor"] = capacity_factor
    jc, tc = _cfgs(arch, **changes)
    with jax.threefry_partitionable(True):
        jp = j_moe.moe_init(jax.random.PRNGKey(5), jc)
    tp = _p(jp)
    x = _x(11, 2, 24, tc.d_model)                  # 3 groups of 16 tokens
    want, want_aux = j_moe.moe_apply(jp, jc, x)
    got, aux = moe.moe_apply(tp, tc, _t(x))
    _close(got, want)
    _close(aux, want_aux)
    xg = x.reshape(3, 16, tc.d_model)
    top_i, slot, keep = _jax_routing(jp, jc, xg)
    _, g_top_i, g_slot, g_keep, _ = moe.route(tp, tc, _t(xg))
    np.testing.assert_array_equal(g_top_i.numpy(), np.asarray(top_i))
    np.testing.assert_array_equal(g_slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(g_keep.numpy(), np.asarray(keep))
    if capacity_factor:
        assert not bool(g_keep.all()), "the capacity must drop some tokens"


def test_moe_block_with_mla_and_its_decode_match_jax():
    jc, tc = _cfgs("deepseek_v2_236b")
    with jax.threefry_partitionable(True):
        jp = j_blocks.moe_block_init(jax.random.PRNGKey(2), jc)
    tp = _p(jp)
    x = _x(3, 2, 12, tc.d_model)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    # jitted: JAX's eager dispatch compiles every primitive of the block
    apply = jax.jit(j_blocks.moe_block_apply, static_argnums=1)
    decode = jax.jit(j_blocks.moe_block_decode, static_argnums=1)
    want, want_aux = apply(jp, jc, x, pos)
    got, aux = blocks.moe_block_apply(tp, tc, _t(x), _t(pos))
    _close(got, want)
    _close(aux, want_aux)
    jcache = jax.tree.map(lambda c: c[0], j_lm.init_cache(jc, 2, 6)["layers"])
    tcache = lm._layer(lm.init_cache(tc, 2, 6, device="cpu")["layers"], 0)
    for p in range(3):
        want, jcache = decode(jp, jc, x[:, p:p + 1], jcache, jnp.int32(p))
        got, tcache = blocks.moe_block_decode(tp, tc, _t(x[:, p:p + 1]),
                                              tcache, p)
        _close(got, want)
        for name in ("ckv", "kpe"):
            _close(tcache[name], jcache[name])


# -------------------------------------------------------------------- MLA --
@pytest.mark.parametrize("window", [None, 5])
def test_mla_self_attention_and_decode_match_jax(window):
    jc, tc = _cfgs("deepseek_v2_236b", sliding_window=window)
    with jax.threefry_partitionable(True):
        jp = j_mla.mla_init(jax.random.PRNGKey(4), jc)
    tp = _p(jp)
    x = _x(5, 2, 14, tc.d_model)
    pos = np.broadcast_to(np.arange(3, 17, dtype=np.int32), (2, 14))
    _close(mla.mla_self_attention(tp, tc, _t(x), _t(pos)),
           j_mla.mla_self_attention(jp, jc, x, pos))
    rs = np.random.default_rng(6)
    ckv = rs.normal(size=(2, 10, tc.kv_lora_rank)).astype(np.float32)
    kpe = rs.normal(size=(2, 10, 1, tc.qk_rope_head_dim)).astype(np.float32)
    for p in (2, 7):
        want = j_mla.mla_decode_attention(jp, jc, x[:, :1], ckv, kpe,
                                          jnp.int32(p))
        got = mla.mla_decode_attention(tp, tc, _t(x[:, :1]), _t(ckv),
                                       _t(kpe), p)
        for g, w in zip(got, want):
            _close(g, w)


# ---------------------------------------------------------- cross / norms --
def test_cross_attention_matches_jax():
    jc, tc = _cfgs("whisper_tiny")
    with jax.threefry_partitionable(True):
        jp = j_attn.cross_attn_init(jax.random.PRNGKey(8), jc)
    x, mem = _x(9, 2, 7, tc.d_model), _x(10, 2, 19, tc.d_model)
    _close(attention.cross_attention(_p(jp), tc, _t(x), _t(mem)),
           j_attn.cross_attention(jp, jc, x, mem))


def test_mrope_nonparametric_ln_and_gelu_match_jax():
    jc, tc = _cfgs("qwen2_vl_7b")
    q = _x(12, 2, 20, 4, 64)
    pos3 = np.asarray(j_lm.build_positions(jc, 2, 20))
    _close(lm.build_positions(tc, 2, 20), pos3, 0)
    _close(layers.apply_mrope(_t(q), _t(pos3), tc, 64),
           j_layers.apply_mrope(q, pos3, jc, 64))
    jo, to = _cfgs("olmo_1b")
    x = 3.0 + 2.0 * _x(13, 2, 9, to.d_model)
    assert layers.norm_init(to, to.d_model) == {}
    _close(layers.norm_apply(to, {}, _t(x)), j_layers.norm_apply(jo, {}, x))
    jw, tw = _cfgs("whisper_tiny")
    with jax.threefry_partitionable(True):
        jp = j_layers.mlp_init(jax.random.PRNGKey(1), jw, tw.d_model, 96)
    assert sorted(jp) == ["down", "up"]
    _close(layers.mlp_apply(tw, _p(jp), _t(x[..., :tw.d_model])),
           j_layers.mlp_apply(jw, jp, x[..., :tw.d_model]))


# ---------------------------------------------------------------- windows --
@pytest.mark.parametrize("window,pos", [(6, 3), (6, 9), (6, 15), (32, 11)])
def test_windowed_decode_matches_jax(window, pos):
    """pos < w, pos >= w (twice: mid cache and the cache's last slot) and
    w >= S (the whole cache of 16)."""
    jc, tc = _cfgs("qwen3_0_6b", sliding_window=window)
    with jax.threefry_partitionable(True):
        jp = j_attn.attn_init(jax.random.PRNGKey(3), jc)
    rs = np.random.default_rng(pos)
    x = _x(pos, 2, 1, tc.d_model)
    ck = rs.normal(size=(2, 16, tc.n_kv_heads, 64)).astype(np.float32)
    cv = rs.normal(size=(2, 16, tc.n_kv_heads, 64)).astype(np.float32)
    want = j_attn.decode_attention(jp, jc, x, ck, cv, jnp.int32(pos))
    got = attention.decode_attention(_p(jp), tc, _t(x), _t(ck), _t(cv), pos)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("window", [1, 4, 13, 40])
def test_windowed_self_attention_matches_jax(window):
    jc, tc = _cfgs("qwen3_0_6b", sliding_window=window)
    with jax.threefry_partitionable(True):
        jp = j_attn.attn_init(jax.random.PRNGKey(3), jc)
    x = _x(window, 2, 24, tc.d_model)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    _close(attention.self_attention(_p(jp), tc, _t(x), _t(pos)),
           j_attn.self_attention(jp, jc, x, pos))
    # kernel 7's plain version against JAX's _sdpa on the windowed mask
    q, k, v = _x(1, 2, 24, 4, 64), _x(2, 2, 24, 2, 64), _x(3, 2, 24, 2, 64)
    i, j = np.arange(24)[:, None], np.arange(24)[None, :]
    mask = (j <= i) & (i - j < window)
    _close(flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                 window=window),
           j_attn._sdpa(q, k, v, mask[None, None, None], 64))
