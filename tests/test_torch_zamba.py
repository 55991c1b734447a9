"""Zamba2 serving in the port against a live run of the JAX package.

Configs: ``get_config("zamba2_1_2b").reduced()`` (2 Mamba2 layers, one
group, the shared attention block after it) and the same with
``n_layers=5`` (2 groups of 2 plus a tail of 1, the group/tail split of
the full 38 = 6 x 6 + 2).  Float32 throughout, PRNG pinned with
``jax.threefry_partitionable(True)``.

* init: the port's ``init_params(PRNGKey(0))`` equals JAX's leaf by leaf
  within rtol=1e-6, atol=1e-7 (threefry is bit-exact; normals differ by an
  ulp of ``log1p``);
* modules, on JAX's own weights: within rtol=atol=1e-5;
* the slice: ``lm.forward`` and ``api.prefill_fn`` logits at B=2, S=16 and
  S=40 (not a chunk multiple: the padding), and 16 cached ``decode_step``
  logits, within rtol=atol=1e-4; the greedy tokens of
  ``serve_decode.serve`` equal those of the same loop in JAX.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import blocks as j_blocks  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve_decode  # noqa: E402
from repro_torch.models import api, attention, blocks, layers, lm, ssm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

VARIANTS = {"reduced": None, "tail": 5}


def _configs(variant):
    jc = j_get_config("zamba2_1_2b").reduced()
    tc = get_config("zamba2_1_2b").reduced()
    if VARIANTS[variant]:
        jc = dataclasses.replace(jc, n_layers=VARIANTS[variant])
        tc = dataclasses.replace(tc, n_layers=VARIANTS[variant])
    return jc, tc


@functools.cache
def _jax_params(variant):
    """JAX's ``init_params(PRNGKey(0))`` of a variant, built once for the
    module: the fixture, the init test and the serving test read it."""
    jc, _ = _configs(variant)
    with jax.threefry_partitionable(True):
        return j_api.init_params(jax.random.PRNGKey(0), jc)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    """(jax cfg, port cfg, jax params, the same params as tensors)."""
    jc, tc = _configs(request.param)
    jp = _jax_params(request.param)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------------ config --
def test_config_registry_mirrors_jax():
    full, j_full = get_config("zamba2-1.2b"), j_get_config("zamba2-1.2b")
    for got, want in ((full, j_full), (full.reduced(), j_full.reduced())):
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert g == w
        for prop in ("head_dim", "padded_vocab", "d_inner", "ssm_heads",
                     "is_moe"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.layer_kinds() == want.layer_kinds()
        assert str(got.param_dtype).split(".")[-1] == str(
            want.param_dtype)
    assert full.param_dtype == torch.bfloat16
    assert INPUT_SHAPES["prefill_32k"]["seq_len"] == 32_768
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("nope")


@pytest.mark.parametrize("field,value", [
    ("sliding_window", 16), ("norm", "nonparametric_ln"), ("mlp", "gelu"),
    ("n_experts", 4), ("encoder_decoder", True), ("mrope", True)])
def test_branch_init_matches_jax(field, value):
    """The reduced Zamba2 with one branch switched on inits as JAX does,
    leaf by leaf (the branches' own parity: tests/test_torch_lm_*.py)."""
    jc = dataclasses.replace(j_get_config("zamba2_1_2b").reduced(),
                             **{field: value})
    tc = dataclasses.replace(get_config("zamba2_1_2b").reduced(),
                             **{field: value})
    with jax.threefry_partitionable(True):
        want = j_api.init_params(jax.random.PRNGKey(0), jc)
    got = api.init_params(rng.PRNGKey(0), tc)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for (path, w), g in zip(want_leaves, got_leaves):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))


# -------------------------------------------------------------------- init --
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_matches_jax(variant):
    jc, tc = _configs(variant)
    want = _jax_params(variant)
    got = api.init_params(rng.PRNGKey(0), tc)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for (path, w), g in zip(want_leaves, got_leaves):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))
    assert lm.n_params(got) == j_lm.n_params(want)


# ----------------------------------------------------------------- modules --
def test_norm_rope_and_mlp_match_jax(model):
    jc, tc, jp, tp = model
    rs = np.random.default_rng(1)
    x = rs.normal(size=(2, 16, tc.d_model)).astype(np.float32)
    _close(layers.norm_apply(tc, tp["final_norm"], _t(x)),
           j_layers.norm_apply(jc, jp["final_norm"], x), 1e-5)
    scale = (1 + 0.1 * rs.normal(size=(64,))).astype(np.float32)
    q = rs.normal(size=(2, 16, 4, 64)).astype(np.float32)
    _close(layers.rms_norm(_t(q), _t(scale)), j_layers.rms_norm(q, scale),
           1e-5)
    pos = np.broadcast_to(np.arange(100, 116, dtype=np.int32), (2, 16))
    _close(layers.apply_rope(_t(q), _t(pos), layers.rope_freqs(tc, 64)),
           j_layers.apply_rope(q, pos, j_layers.rope_freqs(jc, 64)), 1e-5)
    _close(layers.mlp_apply(tc, tp["shared"]["mlp"], _t(x)),
           j_layers.mlp_apply(jc, jp["shared"]["mlp"], x), 1e-5)
    tok = _tokens(2, 2, 5, tc.vocab)
    _close(layers.unembed_logits(tp["embed"], layers.embed_apply(
        tp["embed"], _t(tok)), tc), j_layers.unembed_logits(
        jp["embed"], j_layers.embed_apply(jp["embed"], tok), jc), 1e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_matches_jax(model, qk_norm):
    jc, tc, jp, tp = model
    jc, tc = (dataclasses.replace(c, qk_norm=qk_norm) for c in (jc, tc))
    rs = np.random.default_rng(3)
    ja = dict(jp["shared"]["attn"])
    ta = dict(tp["shared"]["attn"])
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            w = (1 + 0.1 * rs.normal(size=(64,))).astype(np.float32)
            ja[name], ta[name] = jnp.asarray(w), _t(w)
    x = rs.normal(size=(2, 24, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    _close(attention.self_attention(ta, tc, _t(x), _t(pos)),
           j_attn.self_attention(ja, jc, x, pos), 1e-5)
    # one-token decode against a cache holding 5 earlier positions
    ck = rs.normal(size=(2, 12, tc.n_kv_heads, 64)).astype(np.float32)
    cv = rs.normal(size=(2, 12, tc.n_kv_heads, 64)).astype(np.float32)
    x1 = x[:, :1]
    want = j_attn.decode_attention(ja, jc, x1, ck, cv, jnp.int32(5))
    got = attention.decode_attention(ta, tc, _t(x1), _t(ck), _t(cv), 5)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("s", [16, 40])
def test_ssm_forward_and_decode_match_jax(model, s):
    jc, tc, jp, tp = model
    jl = jax.tree.map(lambda w: w[0], jp["layers"])
    tl = lm._layer(tp["layers"], 0)
    rs = np.random.default_rng(s)
    x = rs.normal(size=(2, s, tc.d_model)).astype(np.float32)
    _close(ssm.ssm_forward(tl["ssm"], tc, _t(x)),
           j_ssm.ssm_forward(jl["ssm"], jc, x), 1e-5)
    conv = rs.normal(size=(2, tc.ssm_conv_width - 1,
                           tc.d_inner + 2 * tc.ssm_state)).astype(np.float32)
    state = rs.normal(size=(2, tc.ssm_heads, tc.ssm_state,
                            tc.ssm_head_dim)).astype(np.float32)
    want = j_ssm.ssm_decode(jl["ssm"], jc, x[:, :1], conv, state)
    got = ssm.ssm_decode(tl["ssm"], tc, _t(x[:, :1]), _t(conv), _t(state))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_blocks_match_jax(model):
    jc, tc, jp, tp = model
    rs = np.random.default_rng(7)
    x = rs.normal(size=(2, 40, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    jl = jax.tree.map(lambda w: w[1], jp["layers"])
    tl = lm._layer(tp["layers"], 1)
    for j_fn, t_fn, jw, tw in (
            (j_blocks.ssm_block_apply, blocks.ssm_block_apply, jl, tl),
            (j_blocks.dense_block_apply, blocks.dense_block_apply,
             jp["shared"], tp["shared"])):
        _close(t_fn(tw, tc, _t(x), _t(pos))[0], j_fn(jw, jc, x, pos)[0],
               1e-5)
    jcache = jax.tree.map(lambda c: c[0], j_lm.init_cache(jc, 2, 8))
    tcache = lm._layer(lm.init_cache(tc, 2, 8, device="cpu"), 0)
    x1 = x[:, :1]
    for pos1 in range(3):
        want, jcache_s = j_blocks.ssm_block_decode(
            jl, jc, x1, {"conv": jcache["layers"]["conv"],
                         "state": jcache["layers"]["state"]}, pos1)
        got, tcache_s = blocks.ssm_block_decode(
            tl, tc, _t(x1), {"conv": tcache["layers"]["conv"],
                             "state": tcache["layers"]["state"]}, pos1)
        _close(got, want, 1e-5)
        _close(tcache_s["state"], jcache_s["state"], 1e-5)
        want, jcs = j_blocks.dense_block_decode(
            jp["shared"], jc, x1, jcache["shared"], jnp.int32(pos1))
        got, tcs = blocks.dense_block_decode(tp["shared"], tc, _t(x1),
                                             tcache["shared"], pos1)
        jcache["shared"] = jcs
        _close(got, want, 1e-5)
        _close(tcs["k"], jcs["k"], 1e-5)
        jcache["layers"], tcache["layers"] = jcache_s, tcache_s
        x1 = x[:, pos1 + 1:pos1 + 2]


# --------------------------------------------------------------- the slice --
@pytest.mark.parametrize("s", [16, 40])
def test_forward_and_prefill_match_jax(model, s):
    jc, tc, jp, tp = model
    toks = _tokens(s, 2, s + 1, tc.vocab)
    want, _ = j_lm.forward(jp, jc, {"tokens": toks})
    got, aux = lm.forward(tp, tc, {"tokens": _t(toks)})
    assert got.shape == (2, s, tc.padded_vocab) and float(aux) == 0.0
    _close(got, want, 1e-4)
    want = j_api.prefill_fn(jp, jc, {"tokens": toks[:, :s]})
    got = api.prefill_fn(tp, tc, {"tokens": _t(toks[:, :s])})
    _close(got, want, 1e-4)
    _close(got, lm.forward(tp, tc, {"tokens": _t(toks)})[0][:, -1], 1e-4)


def test_cached_decode_matches_jax(model):
    jc, tc, jp, tp = model
    toks = _tokens(9, 2, 16, tc.vocab)
    decode = jax.jit(lambda p, c, t, pos: j_api.decode_step(p, jc, c, t, pos))
    jcache = j_api.init_cache(jc, 2, 16)
    tcache = api.init_cache(tc, 2, 16, device="cpu")
    got, want = [], []
    for t in range(16):
        w, jcache = decode(jp, jcache, toks[:, t:t + 1], jnp.int32(t))
        g, tcache = api.decode_step(tp, tc, tcache, _t(toks[:, t:t + 1]), t)
        want.append(np.asarray(w))
        got.append(g)
    _close(torch.stack(got), np.stack(want), 1e-4)
    for name in ("conv", "state"):
        _close(tcache["layers"][name], jcache["layers"][name], 1e-4)
    _close(tcache["shared"]["k"], jcache["shared"]["k"], 1e-4)
    # the cached decode of a prompt ends where the one-shot forward does
    fwd, _ = lm.forward(tp, tc, {"tokens": _t(np.concatenate(
        [toks, toks[:, :1]], axis=1))})
    _close(got[-1], fwd[:, -1].numpy(), 1e-4)


def test_serve_decode_greedy_tokens_match_jax():
    jc, tc = _configs("reduced")
    batch, prompt_len, gen_len = 2, 12, 6
    jp = _jax_params("reduced")
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(0)
        cache = j_api.init_cache(jc, batch, prompt_len + gen_len)
        prompt = jax.random.randint(key, (batch, prompt_len), 0, jc.vocab)
    decode = jax.jit(lambda p, c, t, pos: j_api.decode_step(p, jc, c, t, pos))
    for t in range(prompt_len):
        logits, cache = decode(jp, cache, prompt[:, t:t + 1], jnp.int32(t))
    want = []
    for t in range(prompt_len, prompt_len + gen_len):
        nxt = jnp.argmax(logits[:, :jc.vocab], axis=-1)[:, None]
        want.append(np.asarray(nxt))
        logits, cache = decode(jp, cache, nxt.astype(jnp.int32), jnp.int32(t))
    res = serve_decode.serve(tc, "zamba2-reduced", batch=batch,
                             prompt_len=prompt_len, gen_len=gen_len,
                             device="cpu")
    np.testing.assert_array_equal(res.prompt.numpy(), np.asarray(prompt))
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.concatenate(want, axis=1))


def test_serve_decode_cli_runs_on_cpu(capsys):
    res = serve_decode.main(["--device", "cpu", "--reduced", "--batch", "1",
                             "--prompt-len", "3", "--gen-len", "2"])
    assert res.tokens.shape == (1, 2)
    assert "tok/s" in capsys.readouterr().out


def test_params_cross_in_their_own_dtype():
    """bfloat16 weights cross as bfloat16 (through float32, exactly), the
    float32 leaves stay float32."""
    jc = j_get_config("zamba2_1_2b").reduced()
    jc = dataclasses.replace(jc, dtype="bfloat16", n_layers=2)
    with jax.threefry_partitionable(True):
        jp = j_api.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), keep_dtype=True)
    assert tp["embed"]["table"].dtype == torch.bfloat16
    assert tp["layers"]["ssm"]["A_log"].dtype == torch.float32
    assert tp["layers"]["ssm"]["dt_bias"].dtype == torch.float32
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(w, dtype=np.float32))
    port = api.init_params(rng.PRNGKey(0), dataclasses.replace(
        get_config("zamba2_1_2b").reduced(), dtype="bfloat16"))
    for g, w in zip(tree_leaves(port), tree_leaves(tp)):
        assert g.dtype == w.dtype
    # the default stays float32 for every leaf
    assert all(t.dtype == torch.float32 for t in tree_leaves(
        params_from_numpy(jax.tree.map(np.asarray, jp))))
