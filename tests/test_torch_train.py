"""The LM training side of the port against a live run of the JAX package,
for all ten configs at ``reduced()`` in float32 with the PRNG pinned
(``jax.threefry_partitionable(True)``).

One module-scoped live JAX run a config (:func:`_live`, jitted) holds what
the tests compare with, on the same numpy inputs and JAX's weights:

* ``api.loss_fn`` and its gradient (``jax.value_and_grad``): the loss, nll
  and aux within rtol 1e-5, every gradient leaf within 1e-4 of that leaf's
  largest JAX magnitude;
* one ``api.sgd_train_step``: the parameters within rtol 1e-4, atol 1e-6,
  and its metrics;
* MoE's routing ``keep`` masks during the loss, exactly (JAX's taken from
  its own layer inputs);
* ``cfg.remat`` on against off: equal losses and gradients, the layer
  stack applied twice a layer with it (the checkpoint's recompute) and
  once without;
* ``grad_accum=2`` against JAX's ``grad_accum=2`` (OLMo, as
  ``tests/test_dryrun.py::test_grad_accum_matches_full_batch``);
* the batch specs of every config and ``INPUT_SHAPES`` entry, and
  ``roofline.report``'s parameter counts and model FLOPs at full width,
  exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.roofline import report as j_report  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import api, blocks, moe  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

B, S, LR = 2, 16, 1e-2
MOE = [a for a in ARCH_IDS if get_config(a).is_moe]


def _inputs(cfg, seed):
    """numpy inputs: tokens [B, S + 1] (Whisper: [B, 9] decoder tokens and
    32 audio frames), Qwen2-VL's patch embeddings before the text."""
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


def _jax_keep(jp, jc, batch):
    """The routing keep mask of every MoE layer of JAX's own forward, from
    the layer inputs JAX computed (``repro.models.moe.moe_apply``'s
    routing lines; a debug callback hands them out of the jitted
    forward), in layer order."""
    xs = []
    inner = j_moe.moe_apply

    def spy(params, cfg, x):
        jax.debug.callback(lambda *a: xs.append(a), x, params["router"],
                           ordered=True)
        return inner(params, cfg, x)

    j_moe.moe_apply = spy
    try:
        jax.block_until_ready(jax.jit(lambda p, b: j_lm.forward(p, jc, b))(
            jp, batch))
    finally:
        j_moe.moe_apply = inner
    keeps = []
    for x, router in xs:
        t = x.shape[0] * x.shape[1]
        tg = min(jc.moe_group_size, t)
        xg = jnp.asarray(x).reshape(t // tg, tg, -1)
        probs = jax.nn.softmax(xg.astype(jnp.float32) @ router, -1)
        _, top_i = jax.lax.top_k(probs, jc.moe_top_k)
        sel = jax.nn.one_hot(top_i, jc.n_experts, dtype=jnp.int32)
        pos = jnp.cumsum(sel.reshape(xg.shape[0], tg * jc.moe_top_k, -1),
                         axis=1) - 1
        slot = jnp.sum(pos.reshape(sel.shape) * sel, axis=-1)
        keeps.append(np.asarray(slot < j_moe._capacity(jc, tg)))
    return keeps


@functools.cache
def _live(arch):
    """One live JAX run of ``arch`` at reduced(): (jax cfg, port cfg, numpy
    params, numpy inputs, {what: JAX's numpy output})."""
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    batch = _inputs(jc, sum(map(ord, arch)))
    with jax.threefry_partitionable(True):
        jp = jax.jit(lambda k: j_api.init_params(k, jc))(
            jax.random.PRNGKey(0))
    (loss, (nll, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_api.loss_fn(p, jc, b), has_aux=True))(jp, batch)
    stepped, metrics = jax.jit(
        lambda p, b: j_api.sgd_train_step(p, jc, b, lr=LR))(jp, batch)
    want = {"loss": np.asarray(loss), "nll": np.asarray(nll),
            "aux": np.asarray(aux),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "stepped": [np.asarray(p) for p in jax.tree.leaves(stepped)],
            "metrics": {k: np.asarray(v) for k, v in metrics.items()}}
    if jc.is_moe:
        want["keep"] = _jax_keep(jp, jc, batch)
    return jc, tc, jax.tree.map(np.asarray, jp), batch, want


def _port(arch):
    """(port cfg, port params, port batch, JAX's outputs)."""
    _, tc, jp, batch, want = _live(arch)
    return tc, params_from_numpy(jp), {k: torch.tensor(v) for k, v in
                                       batch.items()}, want


def _grads_close(got, want, tol=1e-4):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        lim = tol * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= lim, (i, err, lim)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    tc, tp, tb, want = _port(arch)
    (loss, (nll, aux)), grads = api.value_and_grad(tp, tc, tb)
    for name, got in (("loss", loss), ("nll", nll), ("aux", aux)):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want[name], rtol=1e-5,
                                   err_msg=name)
    _grads_close(tree_leaves(grads), want["grads"])
    # the dispatch: api.loss_fn is the same function value_and_grad reads
    direct, (d_nll, d_aux) = api.loss_fn(tp, tc, tb)
    assert torch.equal(direct, loss) and torch.equal(d_nll, nll)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sgd_train_step_matches_jax(arch):
    tc, tp, tb, want = _port(arch)
    stepped, metrics = api.sgd_train_step(tp, tc, tb, lr=LR)
    got = tree_leaves(stepped)
    assert len(got) == len(want["stepped"])
    for g, w in zip(got, want["stepped"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)
    assert set(metrics) == {"loss", "nll", "aux"}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), want["metrics"][k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", MOE)
def test_moe_keep_masks_match_jax(arch, monkeypatch):
    tc, tp, tb, want = _port(arch)
    keeps = []
    inner = moe.route

    def spy(params, cfg, xg):
        out = inner(params, cfg, xg)
        keeps.append(out[3].numpy())
        return out

    monkeypatch.setattr(moe, "route", spy)
    api.loss_fn(tp, tc, tb)
    assert len(keeps) == len(want["keep"]) > 0
    for got, w in zip(keeps, want["keep"]):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_on_equals_off(arch, monkeypatch):
    """Checkpointing each layer of the stack changes no number; with it the
    backward recomputes each layer (applied twice), without it not."""
    tc, tp, tb, _ = _port(arch)
    main_kind = tc.layer_kinds()[-1]
    inner = blocks.BLOCK_APPLY[main_kind]
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setitem(blocks.BLOCK_APPLY, main_kind, counting)
    stack = 0 if tc.encoder_decoder else tc.n_layers - tc.first_k_dense
    runs = []
    for remat in (True, False):
        calls.clear()
        runs.append(api.value_and_grad(
            tp, dataclasses.replace(tc, remat=remat), tb))
        assert len(calls) == (2 if remat else 1) * stack, remat
    (l_on, _), g_on = runs[0]
    (l_off, _), g_off = runs[1]
    assert torch.equal(l_on, l_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


def test_grad_accum_matches_jax():
    """OLMo reduced, a batch of 4 x 32 in 2 microbatches: the port's step
    against JAX's, and (linear gradients) against the port's full-batch
    step at tests/test_dryrun.py's tolerance."""
    jc = dataclasses.replace(j_get_config("olmo_1b").reduced(), grad_accum=2)
    tc = dataclasses.replace(get_config("olmo_1b").reduced(), grad_accum=2)
    rs = np.random.default_rng(4)
    batch = {"tokens": rs.integers(0, jc.vocab, (4, 33)).astype(np.int32)}
    with jax.threefry_partitionable(True):
        jp = j_api.init_params(jax.random.PRNGKey(0), jc)
    j_new, j_metrics = jax.jit(lambda p, b: j_api.sgd_train_step(p, jc, b))(
        jp, batch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tb = {"tokens": torch.tensor(batch["tokens"])}
    new, metrics = api.sgd_train_step(tp, tc, tb)
    for g, w in zip(tree_leaves(new), jax.tree.leaves(j_new)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(metrics[k].numpy(),
                                   np.asarray(j_metrics[k]), rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    full, _ = api.sgd_train_step(tp, dataclasses.replace(tc, grad_accum=1),
                                 tb)
    for a, b in zip(tree_leaves(full), tree_leaves(new)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)
    with pytest.raises(ValueError, match="grad_accum"):
        api.sgd_train_step(tp, dataclasses.replace(tc, grad_accum=3), tb)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_jax(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    for shape in INPUT_SHAPES.values():
        b, s = shape["global_batch"], shape["seq_len"]
        for fn in ("train_batch_specs", "prefill_batch_specs"):
            want = getattr(j_api, fn)(jc, b, s)
            got = getattr(api, fn)(tc, b, s)
            assert sorted(got) == sorted(want), fn
            for k, w in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == w.shape, (fn, k)
                assert str(got[k].dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_jax(arch):
    assert report._param_counts(arch) == j_report._param_counts(arch)
    for shape in INPUT_SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            assert report.model_flops(arch, shape, kind) == \
                j_report.model_flops(arch, shape, kind)
