"""The port's training substrates against the JAX package's, on the same
inputs: the optimizers, the clip and the schedule
(``repro_torch.optim``), checkpoints (``repro_torch.checkpoint``), the
Markov token corpus (``repro_torch.data.tokens``), the ``train`` CLI
(``repro_torch.launch.train``) and the twin of
``tests/test_system.py::test_lm_end_to_end_learns_bigrams``.

The optimizers run three updates on injected trees (nested dicts and a
list, float32, numpy-made) and hold rtol 1e-6: JAX runs them eagerly, op
by op, as the port does, so they differ by an ulp of ``pow`` at most.
Checkpoints cross between the packages bit for bit, bfloat16 leaves
included.  Token streams are exact; the chain's logits are a normal draw,
which carries C.4's ulp of ``log1p`` (rtol 1e-6, ROADMAP.md).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as j_optim  # noqa: E402
from repro.checkpoint import load_pytree as j_load  # noqa: E402
from repro.checkpoint import save_pytree as j_save  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import tokens as j_tokens  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro_torch import optim, rng  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()


def _tree(seed, scale=1.0):
    rs = np.random.default_rng(seed)

    def a(*shape):
        return (rs.normal(size=shape) * scale).astype(np.float32)

    return {"enc": {"w": a(3, 4), "b": a(4)}, "layers": [a(2, 3), a(5)],
            "scale": a(6)}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _same(got, want, rtol=1e-6, atol=0.0):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


def _run_both(j_opt, t_opt, n=3):
    """n updates of each optimizer on the same injected params and grads;
    the updates and state after each."""
    params = _tree(0)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for i in range(n):
        grads = _tree(10 + i, scale=0.1)
        ju, js = j_opt.update(_to_jax(grads), js, jp)
        tu, ts = t_opt.update(_to_torch(grads), ts, tp)
        _same(tu, ju, atol=1e-12)
        jp, tp = j_optim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        _same(tp, jp)
    assert int(ts.count) == int(js.count) == n
    return js, ts


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
@pytest.mark.parametrize("schedule", [False, True])
def test_sgd_matches_jax(momentum, nesterov, schedule):
    lr = (0.05, j_optim.cosine_warmup_schedule(0.05, 2, 5),
          optim.cosine_warmup_schedule(0.05, 2, 5))
    js, ts = _run_both(
        j_optim.sgd(lr[1] if schedule else lr[0], momentum, nesterov),
        optim.sgd(lr[2] if schedule else lr[0], momentum, nesterov))
    _same(ts.momentum, js.momentum)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_jax(weight_decay, schedule):
    j_lr = j_optim.cosine_warmup_schedule(3e-3, 2, 5) if schedule else 3e-3
    t_lr = optim.cosine_warmup_schedule(3e-3, 2, 5) if schedule else 3e-3
    js, ts = _run_both(j_optim.adamw(j_lr, weight_decay=weight_decay),
                       optim.adamw(t_lr, weight_decay=weight_decay))
    _same(ts.mu, js.mu)
    _same(ts.nu, js.nu)
    assert all(x.dtype == torch.float32 for x in tree_leaves(ts.mu))


def test_adamw_keeps_float32_moments_of_bfloat16_params():
    params = tree_map(lambda x: x.to(torch.bfloat16), _to_torch(_tree(0)))
    opt = optim.adamw(1e-3, weight_decay=0.01)
    state = opt.init(params)
    updates, state = opt.update(_to_torch(_tree(1, 0.1)), state, params)
    assert all(u.dtype == torch.bfloat16 for u in tree_leaves(updates))
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.nu))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_and_global_norm_match_jax(max_norm):
    tree = _tree(3)
    np.testing.assert_allclose(
        optim.global_norm(_to_torch(tree)).numpy(),
        np.asarray(j_optim.optimizers.global_norm(_to_jax(tree))), rtol=1e-6)
    got = optim.clip_by_global_norm(_to_torch(tree), max_norm)
    _same(got, j_optim.clip_by_global_norm(_to_jax(tree), max_norm))
    if max_norm > 1e2:       # below the norm nothing moves
        _same(got, tree, rtol=0.0)


def test_clip_promotes_bfloat16_as_jax():
    tree = {"w": np.ones((4,), np.float32)}
    jt = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    tt = {"w": torch.ones(4, dtype=torch.bfloat16)}
    assert optim.clip_by_global_norm(tt, 1.0)["w"].dtype == torch.float32
    assert j_optim.clip_by_global_norm(jt, 1.0)["w"].dtype == jnp.float32


@pytest.mark.parametrize("warmup,total,final", [(10, 50, 0.1), (0, 7, 0.0),
                                                (3, 3, 0.5)])
def test_cosine_warmup_schedule_matches_jax(warmup, total, final):
    j_sched = j_optim.cosine_warmup_schedule(3e-3, warmup, total, final)
    t_sched = optim.cosine_warmup_schedule(3e-3, warmup, total, final)
    counts = np.arange(total + 5, dtype=np.int32)
    for c in counts:
        got = t_sched(torch.tensor(c))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(
            j_sched(jnp.asarray(c))), rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------- checkpoint --
def _mixed_tree(seed):
    """float32, bfloat16 and int32 leaves in nested dicts and a list."""
    rs = np.random.default_rng(seed)
    return {"embed": {"table": rs.normal(size=(7, 4)).astype(np.float32)},
            "layers": [{"w": rs.normal(size=(4, 4)).astype(np.float32)},
                       {"w": rs.normal(size=(4, 4)).astype(np.float32)}],
            "norm": rs.normal(size=(4,)).astype(np.float32),
            "steps": np.arange(3, dtype=np.int32)}


def _bf16_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["layers"][1]["w"] = out["layers"][1]["w"].astype(jnp.bfloat16)
    out["norm"] = out["norm"].astype(jnp.bfloat16)
    return out


def _bf16_torch(tree):
    out = tree_map(lambda x: torch.tensor(x), tree)
    out["layers"][1]["w"] = out["layers"][1]["w"].to(torch.bfloat16)
    out["norm"] = out["norm"].to(torch.bfloat16)
    return out


def _bits(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def test_jax_checkpoint_loads_in_port_bit_for_bit(tmp_path):
    tree = _mixed_tree(0)
    jt = _bf16_jax(tree)
    j_save(str(tmp_path / "j.npz"), jt, step=7)
    like = tree_map(torch.zeros_like, _bf16_torch(_mixed_tree(1)))
    got = load_pytree(str(tmp_path / "j.npz"), like)
    for g, w, lk in zip(tree_leaves(got), jax.tree.leaves(jt),
                        tree_leaves(like)):
        assert g.dtype == lk.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path):
    tt = _bf16_torch(_mixed_tree(2))
    save_pytree(str(tmp_path / "t.npz"), tt, step=3)
    like = jax.tree.map(jnp.zeros_like, _bf16_jax(_mixed_tree(1)))
    got = j_load(str(tmp_path / "t.npz"), like)
    for g, w in zip(jax.tree.leaves(got), tree_leaves(tt)):
        assert str(np.asarray(g).dtype) == str(w.dtype).split(".")[-1]
        np.testing.assert_array_equal(_bits(g), _bits(w))
    meta = np.load(str(tmp_path / "t.npz"))["__meta__"].tobytes()
    assert b'"step": 3' in meta and b'"00001|layers/0/w"' in meta
    # and the port reads its own file back bit for bit
    back = load_pytree(str(tmp_path / "t.npz"),
                       tree_map(torch.zeros_like, tt))
    for g, w in zip(tree_leaves(back), tree_leaves(tt)):
        assert torch.equal(g, w)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    tt = _bf16_torch(_mixed_tree(0))
    save_pytree(str(tmp_path / "t.npz"), tt)
    like = tree_map(torch.zeros_like, tt)
    like["layers"][0]["w"] = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="shape mismatch at 00001"):
        load_pytree(str(tmp_path / "t.npz"), like)


# ------------------------------------------------------------------ tokens --
@pytest.mark.parametrize("vocab,top", [(512, 8), (1000, 64), (50, 8)])
def test_markov_chain_matches_jax(vocab, top):
    with jax.threefry_partitionable(True):
        succ, logits = j_tokens.markov_chain(3, vocab, top)
    t_succ, t_logits = tokens.markov_chain(3, vocab, top)
    assert t_succ.dtype == torch.int32
    np.testing.assert_array_equal(t_succ.numpy(), np.asarray(succ))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits),
                               rtol=1e-6)


@pytest.mark.parametrize("seed,vocab,batch,seq,top", [
    (1, 512, 8, 64, 8), (0, 512, 16, 64, 8), (5, 1000, 3, 17, 64)])
def test_token_batches_match_jax(seed, vocab, batch, seq, top):
    with jax.threefry_partitionable(True):
        want = [np.asarray(b["tokens"]) for b in j_tokens.token_batches(
            seed, vocab, batch, seq, 3, top=top)]
    got = [b["tokens"] for b in token_batches(seed, vocab, batch, seq, 3,
                                              top=top)]
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (batch, seq + 1)
        np.testing.assert_array_equal(g.numpy(), w)


def test_sample_stream_of_one_key_matches_jax():
    with jax.threefry_partitionable(True):
        succ, logits = j_tokens.markov_chain(4, 300, 8)
        want = j_tokens.sample_stream(jax.random.PRNGKey(9), succ, logits,
                                      40)
    got = tokens.sample_stream(rng.PRNGKey(9),
                               torch.tensor(np.asarray(succ)),
                               torch.tensor(np.asarray(logits)), 40)
    assert got.dtype == torch.int32 and tuple(got.shape) == (40,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------------- train --
def test_train_cli_matches_a_jax_loop(capsys):
    """``python -m repro_torch.launch.train --device cpu --arch olmo-1b
    --steps 5`` against the loop of ``repro.launch.train`` on the same
    config: the losses within rtol 1e-3."""
    losses = train_cli.main(["--device", "cpu", "--arch", "olmo-1b",
                             "--steps", "5"])
    out = capsys.readouterr().out
    assert "arch=olmo-1b-reduced" in out and "step    4 loss=" in out
    cfg = j_get_config("olmo-1b").reduced()
    with jax.threefry_partitionable(True):
        params = j_api.init_params(jax.random.PRNGKey(0), cfg)
        opt = j_optim.adamw(j_optim.cosine_warmup_schedule(3e-3, 10, 5),
                            weight_decay=0.01)
        state = opt.init(params)

        @jax.jit
        def step(params, state, batch):
            (loss, _), grads = jax.value_and_grad(
                lambda p: j_api.loss_fn(p, cfg, batch), has_aux=True)(params)
            grads = j_optim.clip_by_global_norm(grads, 1.0)
            updates, state = opt.update(grads, state, params)
            return j_optim.apply_updates(params, updates), state, loss

        want = []
        for batch in j_tokens.token_batches(1, cfg.vocab, 8, 128, 5, top=8):
            params, state, loss = step(params, state, batch)
            want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-3)


def test_train_cli_saves_a_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "olmo.npz")
    # the schedule's first step has lr 0: the second one moves the weights
    train_cli.main(["--device", "cpu", "--arch", "olmo-1b", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--ckpt", path])
    assert f"saved {path}" in capsys.readouterr().out
    cfg = get_config("olmo-1b").reduced()
    like = api.init_params(rng.PRNGKey(0), cfg)
    got = load_pytree(path, like)
    assert len(tree_leaves(got)) == len(tree_leaves(like))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(like)))


def test_lm_end_to_end_learns_bigrams():
    """Tiny LM + AdamW on the Markov corpus: the port's twin of the JAX
    test, same config, corpus and bounds."""
    cfg = get_config("olmo_1b").reduced()
    params = api.init_params(rng.PRNGKey(0), cfg)
    opt = optim.adamw(3e-3)
    state = opt.init(params)
    losses = []
    for batch in token_batches(0, cfg.vocab, batch=16, seq_len=64,
                               n_batches=100, top=8):
        (loss, _), grads = api.value_and_grad(params, cfg, batch)
        updates, state = opt.update(grads, state, params)
        params = optim.apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < math.log(cfg.vocab) - 0.5
    assert losses[-1] < losses[0]
