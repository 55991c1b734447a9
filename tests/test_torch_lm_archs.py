"""The nine LM configs beside Zamba2 in the port against a live run of the
JAX package: ``qwen3_0_6b``, ``qwen3_32b``, ``deepseek_67b``, ``olmo_1b``,
``mamba2_2_7b``, ``qwen3_moe_30b_a3b``, ``deepseek_v2_236b``,
``whisper_tiny`` and ``qwen2_vl_7b``.

Each config runs at ``reduced()`` in float32 with the PRNG pinned
(``jax.threefry_partitionable(True)``); one module-scoped live JAX run a
config (:func:`_live`) holds everything the tests compare with:

* the registry: ``dataclasses.asdict``, the derived properties and
  ``layer_kinds`` equal JAX's, full and reduced;
* init: ``init_params(PRNGKey(0))`` leaf by leaf within rtol=1e-6,
  atol=1e-7 (threefry is bit-exact; normals differ by an ulp of
  ``log1p``), lists (DeepSeek-V2's ``first_dense``) in JAX's order;
* ``lm.forward`` / ``encdec.forward`` and ``api.prefill_fn`` logits at
  B = 2 on 16 text tokens (Whisper: 32 frames of audio embeddings and 8
  decoder tokens; Qwen2-VL: 16 patch embeddings before the text), and 8
  cached ``decode_step`` logits, within rtol=atol=1e-4; Whisper decodes
  twice, with the cache's memory left zero as the reference leaves it
  (ROADMAP.md C.15) and with ``cache["memory"] = encode(...)``;
* greedy tokens of ``serve_decode.serve`` exactly equal to the same loop
  in JAX (``examples/serve_decode.py``'s defaults: B = 4, prompt 32, 16
  new tokens) for the JAX example's three runs (qwen3, qwen3 with a
  16-token window, mamba2), whisper and qwen3-moe;
* ``api.cast_params`` of a float32 init is the bfloat16 init bit for bit
  (every config, Zamba2 too);
* a blockwise draw equals the one-piece draw bit for bit.
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
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import ALIASES, get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve_decode  # noqa: E402
from repro_torch.models import api, encdec, lm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

ARCHS = ["qwen3_0_6b", "qwen3_32b", "deepseek_67b", "olmo_1b",
         "mamba2_2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
         "whisper_tiny", "qwen2_vl_7b"]
B, S, STEPS = 2, 16, 8


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


def _inputs(cfg, seed):
    """numpy inputs: tokens [B, S + 1] (Whisper: [B, 9]), and the audio
    frames [B, 32, fd] or patch embeddings [B, n_patches, fd]."""
    rs = np.random.default_rng(seed)
    t = 8 if cfg.encoder_decoder else S
    batch = {"tokens": rs.integers(0, cfg.vocab, (B, t + 1)).astype(np.int32)}
    if cfg.encoder_decoder:
        batch["audio_embeds"] = rs.normal(
            size=(B, 32, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rs.normal(
            size=(B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return batch


def _prefill_batch(batch):
    return dict(batch, tokens=batch["tokens"][:, :-1])


def _jax_decode(jc, jp, cache, toks, memory=None):
    decode = jax.jit(lambda p, c, t, pos: j_api.decode_step(p, jc, c, t, pos))
    if memory is not None:
        cache = dict(cache, memory=memory)
    out = []
    for t in range(toks.shape[1]):
        logits, cache = decode(jp, cache, toks[:, t:t + 1], jnp.int32(t))
        out.append(np.asarray(logits))
    return np.stack(out)


@functools.cache
def _live(arch):
    """One live JAX run of ``arch`` at reduced(): (jax cfg, port cfg, jax
    params, numpy inputs, {what: JAX's numpy output})."""
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    batch = _inputs(jc, sum(map(ord, arch)))
    with jax.threefry_partitionable(True):
        jp = j_api.init_params(jax.random.PRNGKey(0), jc)
    fwd_mod = j_encdec if jc.encoder_decoder else j_lm
    want = {"forward": np.asarray(fwd_mod.forward(jp, jc, batch)[0]),
            "prefill": np.asarray(j_api.prefill_fn(jp, jc,
                                                   _prefill_batch(batch)))}
    toks = batch["tokens"][:, :STEPS]
    cache = j_api.init_cache(jc, B, STEPS)
    want["decode"] = _jax_decode(jc, jp, cache, toks)
    if jc.encoder_decoder:
        memory = j_encdec.encode(jp, jc, batch["audio_embeds"][:, :STEPS])
        want["decode_memory"] = _jax_decode(jc, jp, cache, toks, memory)
    return jc, tc, jp, batch, want


@pytest.fixture(scope="module", params=ARCHS)
def live(request):
    jc, tc, jp, batch, want = _live(request.param)
    return jc, tc, params_from_numpy(jax.tree.map(np.asarray, jp)), batch, \
        want


# ------------------------------------------------------------------ config --
@pytest.mark.parametrize("arch", ARCHS)
def test_config_registry_mirrors_jax(arch):
    alias = next(a for a, i in ALIASES.items() if i == arch)
    full, j_full = get_config(alias), j_get_config(arch)
    for got, want in ((full, j_full), (full.reduced(), j_full.reduced())):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("head_dim", "padded_vocab", "d_inner", "ssm_heads",
                     "is_moe"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.layer_kinds() == want.layer_kinds()
        assert str(got.param_dtype).split(".")[-1] == str(want.param_dtype)


# -------------------------------------------------------------------- init --
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_jax(arch):
    jc, tc, jp, _, _ = _live(arch)
    got = api.init_params(rng.PRNGKey(0), tc)
    want_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for (path, w), g in zip(want_leaves, got_leaves):
        assert tuple(g.shape) == w.shape, path
        assert g.dtype == torch.float32, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))
    if jc.first_k_dense:
        assert isinstance(got["first_dense"], list)
        assert len(got["first_dense"]) == jc.first_k_dense


@pytest.mark.parametrize("arch", ARCHS + ["zamba2_1_2b"])
def test_cast_params_is_the_bfloat16_init(arch):
    """``api.cast_params`` of a float32 init is, leaf for leaf and bit for
    bit, the bfloat16 init from the same key (the leaves the inits keep
    float32 stay float32)."""
    cfg = get_config(arch).reduced()
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    got = tree_leaves(api.cast_params(
        api.init_params(rng.PRNGKey(0), cfg), bf16))
    want = tree_leaves(api.init_params(rng.PRNGKey(0), bf16))
    assert len(got) == len(want)
    assert any(w.dtype == torch.bfloat16 for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("block", [1, 5, 64, 1000])
def test_blockwise_draw_equals_one_piece(monkeypatch, block):
    """A draw walked in blocks of its flat counter range (over batched
    keys too) gives the one-piece numbers bit for bit, and so does a draw
    of one block alone along any dim (``block``: a rank's share of a
    weight)."""
    key = rng.PRNGKey(7)
    keys = rng.split(key, 3)
    cases = ((key, (37, 11)), (keys, (4, 9)), (key, ()))
    want = [(rng.normal(k, s), rng.uniform(k, s, -2.0, 3.0),
             rng.random_bits(k, s)) for k, s in cases]
    monkeypatch.setattr(rng, "BLOCK", block)
    for (k, s), (normal, uniform, bits) in zip(cases, want):
        assert torch.equal(rng.normal(k, s), normal)
        assert torch.equal(rng.uniform(k, s, -2.0, 3.0), uniform)
        assert torch.equal(rng.random_bits(k, s), bits)
        for dim in range(len(s)):
            for first, count in ((1, 2), (0, s[dim]), (s[dim] - 3, 3)):
                assert torch.equal(
                    rng.normal(k, s, block=(dim, first, count)),
                    normal.narrow(normal.dim() - len(s) + dim, first, count))


# --------------------------------------------------------------- the slice --
def test_forward_and_prefill_match_jax(live):
    jc, tc, tp, batch, want = live
    tb = {k: _t(v) for k, v in batch.items()}
    fwd_mod = encdec if tc.encoder_decoder else lm
    got, aux = fwd_mod.forward(tp, tc, tb)
    assert got.shape == want["forward"].shape
    assert got.shape[-1] == tc.padded_vocab and bool(torch.isfinite(aux))
    _close(got, want["forward"], 1e-4)
    pre = api.prefill_fn(tp, tc, _prefill_batch(tb))
    _close(pre, want["prefill"], 1e-4)
    _close(pre, got[:, -1], 1e-4)


def test_cached_decode_matches_jax(live):
    jc, tc, tp, batch, want = live
    toks = _t(batch["tokens"][:, :STEPS])
    runs = [("decode", None)]
    if tc.encoder_decoder:
        runs.append(("decode_memory", encdec.encode(
            tp, tc, _t(batch["audio_embeds"][:, :STEPS]))))
    for what, memory in runs:
        cache = api.init_cache(tc, B, STEPS, device="cpu")
        if memory is not None:
            cache["memory"] = memory
        steps = [api.decode_step(tp, tc, cache, toks[:, t:t + 1], t)[0]
                 for t in range(STEPS)]
        _close(torch.stack(steps), want[what], 1e-4)


SERVES = {"qwen3": ("qwen3_0_6b", {}),
          "qwen3_sliding16": ("qwen3_0_6b", {"sliding_window": 16}),
          "mamba2": ("mamba2_2_7b", {}),
          "whisper": ("whisper_tiny", {}),
          "qwen3_moe": ("qwen3_moe_30b_a3b", {})}


@pytest.mark.parametrize("run", list(SERVES))
def test_serve_greedy_tokens_match_jax(run):
    """``examples/serve_decode.py``'s loop (B = 4, prompt 32, 16 new
    tokens, weights and prompt from PRNGKey(0)) against the port's
    ``serve`` with its own weights from the same key: the same prompt and
    the same greedy tokens."""
    arch, changes = SERVES[run]
    jc = dataclasses.replace(j_get_config(arch).reduced(), **changes)
    tc = dataclasses.replace(get_config(arch).reduced(), **changes)
    batch, prompt_len, gen_len = 4, 32, 16
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(0)
        jp = _live(arch)[2]
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
    res = serve_decode.serve(tc, run, batch=batch, prompt_len=prompt_len,
                             gen_len=gen_len, device="cpu")
    np.testing.assert_array_equal(res.prompt.numpy(), np.asarray(prompt))
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.concatenate(want, axis=1))


@pytest.mark.parametrize("arch", ["whisper_tiny", "qwen2_vl_7b"])
def test_make_train_batch_matches_jax(arch):
    """The Whisper and VLM prefill inputs: the same tokens, and embeddings
    within an ulp of ``log1p`` (rtol 1e-6)."""
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    with jax.threefry_partitionable(True):
        want = j_api.make_train_batch(jax.random.PRNGKey(3), jc, 2, 64)
    got = api.make_train_batch(rng.PRNGKey(3), tc, 2, 64)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    for name in set(got) - {"tokens"}:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-7)


def test_serve_decode_cli_takes_every_config_and_a_window(capsys):
    for arch in ARCHS:
        res = serve_decode.main(["--config", arch, "--device", "cpu",
                                 "--reduced", "--batch", "1",
                                 "--prompt-len", "3", "--gen-len", "2"])
        assert res.tokens.shape == (1, 2)
    res = serve_decode.main(["--config", "qwen3-0.6b", "--device", "cpu",
                             "--reduced", "--sliding-window", "2",
                             "--batch", "1", "--prompt-len", "5",
                             "--gen-len", "2"])
    assert res.tokens.shape == (1, 2)
    assert "tok/s" in capsys.readouterr().out
