"""repro_torch's tensor-parallel LM (``launch.sharding``'s LM rules,
``launch.mesh.smoke_mesh``, ``models.parallel``) against the JAX package's
rules and live runs, and against the unsharded port.

* The rules: for each of the ten configs at full width, the port's
  ``param_pspecs`` on a ``meta`` tree equals JAX's on
  ``jax.eval_shape(init_params)`` leaf for leaf at model sizes 1, 2, 4, 8
  and 16; ``batch_pspecs`` at data 1 and 2; ``cache_pspecs`` in all four
  ``cache_seq_shard`` modes.  The mesh is a stand-in carrying
  ``axis_names``, ``shape`` and ``devices.shape``.
* A world of one, in this process: a (1, 1) mesh serves the four dense
  configs bit-equal to the unsharded port.
* Refusals: a model axis that does not divide ``n_kv_heads`` (reduced
  deepseek-67b has KV = 1), a config outside the dense family, a
  ``--mesh`` of several ranks without torchrun.
* One four-rank ``torchrun`` job (``tests/_torch_tp_job.py``, gloo on the
  CPU): reduced qwen3-0.6b at mesh (2, 2) and reduced olmo-1b at (1, 4),
  in float32.  Each rank's weights are its blocks of the unsharded init,
  bit for bit.  Prefill logits are within 1e-5 of the largest magnitude
  of the unsharded port's and within 1e-4 of live JAX
  ``repro.models.api.prefill_fn``'s.  The 8 greedy decode tokens equal
  JAX's (``examples/serve_decode.py``'s loop) and are the same on every
  rank, through ``serve(mesh=)`` and the ``--mesh`` CLI.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import sharding as j_sharding  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve_decode, sharding  # noqa: E402
from repro_torch.launch.mesh import smoke_mesh  # noqa: E402
from repro_torch.models import api, parallel  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from test_torch_slice import cap_torch_threads  # noqa: E402
import _torch_tp_job as job  # noqa: E402

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3_0_6b", "qwen3_32b", "deepseek_67b", "olmo_1b",
         "mamba2_2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
         "whisper_tiny", "qwen2_vl_7b", "zamba2_1_2b"]
DENSE = ["qwen3_0_6b", "qwen3_32b", "deepseek_67b", "olmo_1b"]
MODEL_SIZES = [1, 2, 4, 8, 16]
MODES = ["none", "model", "dp_model", "auto"]
CACHE_MESHES = [(1, 1), (2, 2), (2, 8), (1, 16)]


def _mesh(data: int, model: int):
    """A mesh stand-in both packages' rules read."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape=(data, model),
                                 devices=np.empty((data, model)))


def _specs(tree) -> list:
    """A spec tree's leaves as plain tuples (JAX's PartitionSpecs are
    leaves of their tree; the port's are tuples)."""
    is_spec = lambda x: isinstance(x, (jax.sharding.PartitionSpec, tuple))
    return [tuple(s) for s in jax.tree_util.tree_leaves(tree,
                                                        is_leaf=is_spec)]


def _shapes(tree) -> list:
    return [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)]


@functools.cache
def _params_shape(arch):
    """(JAX's eval_shape'd params, the port's meta params) at full width."""
    want = jax.eval_shape(lambda: j_api.init_params(jax.random.PRNGKey(0),
                                                    j_get_config(arch)))
    got = api.init_params(rng.PRNGKey(0, device="meta"), get_config(arch))
    assert _shapes(want) == [tuple(w.shape) for w in tree_leaves(got)]
    return want, got


# ------------------------------------------------------------------ rules --
@pytest.mark.parametrize("model", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, model):
    want_shape, got_shape = _params_shape(arch)
    mesh = _mesh(1, model)
    want = _specs(j_sharding.param_pspecs(j_get_config(arch), want_shape,
                                          mesh))
    got = _port_leaves(sharding.param_pspecs(get_config(arch), got_shape,
                                             mesh))
    assert got == want
    if model > 1:
        assert any("model" in s for s in got)


def _port_leaves(tree) -> list:
    """The port's spec tree's leaves (tuples) in tree order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for t in tree for s in _port_leaves(t)]
    return [tree]


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_match_jax(arch, data):
    jc, tc = j_get_config(arch), get_config(arch)
    mesh = _mesh(data, 4)
    for b in (1, 2, 8):
        for j_fn, t_fn in ((j_api.train_batch_specs, api.train_batch_specs),
                           (j_api.prefill_batch_specs,
                            api.prefill_batch_specs)):
            want_batch, got_batch = j_fn(jc, b, 4096), t_fn(tc, b, 4096)
            assert sorted(want_batch) == sorted(got_batch)
            assert _shapes(want_batch) == [
                tuple(got_batch[k].shape) for k in sorted(got_batch)]
            want = _specs(j_sharding.batch_pspecs(jc, want_batch, mesh))
            got = _port_leaves(sharding.batch_pspecs(tc, got_batch, mesh))
            assert got == want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_jax(arch, mode):
    jc = dataclasses.replace(j_get_config(arch), cache_seq_shard=mode)
    tc = dataclasses.replace(get_config(arch), cache_seq_shard=mode)
    for b, s in ((1, 4096), (8, 1024)):
        want_cache = jax.eval_shape(lambda: j_api.init_cache(jc, b, s))
        got_cache = api.init_cache(tc, b, s, device="meta")
        assert _shapes(want_cache) == [tuple(w.shape)
                                       for w in tree_leaves(got_cache)]
        for shape in CACHE_MESHES:
            mesh = _mesh(*shape)
            for seq_shard in (False, True):
                want = _specs(j_sharding.cache_pspecs(jc, want_cache, mesh,
                                                      seq_shard=seq_shard))
                got = _port_leaves(sharding.cache_pspecs(
                    tc, got_cache, mesh, seq_shard=seq_shard))
                assert got == want, (shape, b, seq_shard)


# ------------------------------------------------------- a world of one --
@pytest.mark.parametrize("arch", DENSE)
def test_world_of_one_is_the_unsharded_port(arch):
    """A (1, 1) mesh: the local config draws the same weights, and the
    prefill logits and the served tokens are bit-equal."""
    cfg = get_config(arch).reduced()
    mesh = smoke_mesh(1, 1, device="cpu")
    lcfg = parallel.local_config(cfg, mesh)
    assert lcfg.head_dim == cfg.head_dim and lcfg.n_heads == cfg.n_heads
    want_p = api.init_params(rng.PRNGKey(0), cfg)
    got_p = api.init_params(rng.PRNGKey(0), lcfg)
    for g, w in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert torch.equal(g, w)
    tokens = torch.from_numpy(job.prefill_tokens(cfg))
    assert torch.equal(api.prefill_fn(got_p, lcfg, {"tokens": tokens}),
                       api.prefill_fn(want_p, cfg, {"tokens": tokens}))
    want = serve_decode.serve(cfg, arch, device="cpu", params=want_p,
                              **job.SERVE)
    got = serve_decode.serve(cfg, arch, device="cpu", params=got_p,
                             mesh=mesh, **job.SERVE)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.prompt_logits, want.prompt_logits)


def test_local_config_pins_the_head_width():
    """deepseek-67b sets no d_head: a rank's config keeps 128, not
    d_model // (n_heads / m)."""
    cfg = get_config("deepseek_67b")
    assert cfg.d_head is None
    lcfg = parallel.local_config(cfg, _mesh(1, 4))
    assert (lcfg.n_heads, lcfg.n_kv_heads, lcfg.d_ff, lcfg.head_dim,
            lcfg.padded_vocab) == (16, 2, 5504, 128, cfg.padded_vocab)


# ---------------------------------------------------------------- refusals --
def test_refuses_a_split_kv_head():
    cfg = get_config("deepseek_67b").reduced()
    assert cfg.n_kv_heads == 1
    with pytest.raises(ValueError, match="n_kv_heads"):
        parallel.local_config(cfg, _mesh(1, 2))
    # JAX's rule still shards wk: it is the executor that refuses
    want_shape, _ = _params_shape("deepseek_67b")
    mesh = _mesh(1, 16)
    specs = j_sharding.param_pspecs(j_get_config("deepseek_67b"), want_shape,
                                    mesh)
    assert tuple(specs["layers"]["attn"]["wk"]) == (None, None, "model")
    with pytest.raises(ValueError, match="n_kv_heads"):
        parallel.local_config(get_config("deepseek_67b"), mesh)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mamba2_2_7b",
                                  "whisper_tiny", "deepseek_v2_236b"])
def test_refuses_configs_outside_the_dense_family(arch):
    with pytest.raises(ValueError, match="dense attention family"):
        parallel.local_config(get_config(arch).reduced(), _mesh(1, 2))


def test_cli_mesh_needs_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        serve_decode.main(["--config", "qwen3_0_6b", "--reduced",
                           "--device", "cpu", "--mesh", "1,2"])
    with pytest.raises(SystemExit):
        serve_decode.main(["--config", "qwen3_0_6b", "--reduced",
                           "--device", "cpu", "--mesh", "2"])


# ---------------------------------------------------------- four ranks --
@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The torchrun job's per-rank outputs."""
    out = tmp_path_factory.mktemp("tp")
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT)]
                           + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(job.WORLD),
         str(ROOT / "tests" / "_torch_tp_job.py"), str(out)], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = []
    for r in range(job.WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@functools.cache
def _reference(arch):
    """(the unsharded port's prefill logits and served tokens, live JAX's
    prefill logits and greedy tokens) of ``arch`` reduced."""
    cfg = get_config(arch).reduced()
    tokens = job.prefill_tokens(cfg)
    params = api.init_params(rng.PRNGKey(0), cfg)
    port = (api.prefill_fn(params, cfg, {"tokens": torch.from_numpy(tokens)}
                           ).numpy(),
            serve_decode.serve(cfg, arch, device="cpu", params=params,
                               **job.SERVE).tokens.numpy())
    jc = j_get_config(arch).reduced()
    b, prompt_len, gen_len = (job.SERVE[k] for k in
                              ("batch", "prompt_len", "gen_len"))
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(0)
        jp = j_api.init_params(key, jc)
        cache = j_api.init_cache(jc, b, prompt_len + gen_len)
        prompt = jax.random.randint(key, (b, prompt_len), 0, jc.vocab)
    want_logits = np.asarray(j_api.prefill_fn(jp, jc, {"tokens": tokens}))
    decode = jax.jit(lambda p, c, t, pos: j_api.decode_step(p, jc, c, t, pos))
    for t in range(prompt_len):
        logits, cache = decode(jp, cache, prompt[:, t:t + 1], jnp.int32(t))
    want_tokens = []
    for t in range(prompt_len, prompt_len + gen_len):
        nxt = jnp.argmax(logits[:, :jc.vocab], axis=-1)[:, None]
        want_tokens.append(np.asarray(nxt))
        logits, cache = decode(jp, cache, nxt.astype(jnp.int32),
                               jnp.int32(t))
    return port, (want_logits, np.concatenate(want_tokens, axis=1))


RUNS = dict(job.RUNS)


def test_four_ranks_lay_the_mesh_out_data_major(four_ranks):
    for r, res in enumerate(four_ranks):
        assert (res["rank"], res["world_size"]) == (r, job.WORLD)
        for arch, (data, model) in RUNS.items():
            assert (res[arch]["data_rank"], res[arch]["model_rank"]) == \
                (r // model, r % model)


@pytest.mark.parametrize("arch", list(RUNS))
def test_each_rank_holds_its_blocks_of_the_init(four_ranks, arch):
    """The layer-by-layer sharded draw keeps exactly ``shard_params`` of
    the unsharded init; the batch rows follow ``batch_pspecs``."""
    cfg = get_config(arch).reduced()
    data, model = RUNS[arch]
    full = api.init_params(rng.PRNGKey(0), cfg)
    tokens = job.prefill_tokens(cfg)
    for r, res in enumerate(four_ranks):
        mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape=(data, model), data=data,
                                     model=model, model_rank=r % model)
        want = parallel.shard_params(full, mesh)
        got = res[arch]["params"]
        assert [w.shape for w in tree_leaves(want)] == [
            np.shape(g) for g in jax.tree_util.tree_leaves(got)]
        for g, w in zip(jax.tree_util.tree_leaves(got), tree_leaves(want)):
            np.testing.assert_array_equal(g, w.numpy())
        n = job.B // data
        np.testing.assert_array_equal(
            res[arch]["rows"], tokens[(r // model) * n:(r // model + 1) * n])
        assert res[arch]["local_logits_shape"] == (n, cfg.padded_vocab
                                                   // model)


@pytest.mark.parametrize("arch", list(RUNS))
def test_tp_prefill_matches_the_port_and_jax(four_ranks, arch):
    (port_logits, _), (jax_logits, _) = _reference(arch)
    scale = float(np.abs(port_logits).max())
    for res in four_ranks:
        got = res[arch]["logits"]
        assert got.shape == port_logits.shape
        assert float(np.abs(got - port_logits).max()) <= 1e-5 * scale
        np.testing.assert_allclose(got, jax_logits, rtol=1e-4, atol=1e-4)
        # every rank holds the same whole-vocab logits
        np.testing.assert_array_equal(got, four_ranks[0][arch]["logits"])


@pytest.mark.parametrize("arch", list(RUNS))
def test_tp_greedy_tokens_equal_jax(four_ranks, arch):
    (_, port_tokens), (_, jax_tokens) = _reference(arch)
    np.testing.assert_array_equal(port_tokens, jax_tokens)
    for res in four_ranks:
        np.testing.assert_array_equal(res[arch]["tokens"], jax_tokens)
        np.testing.assert_array_equal(res[arch]["prompt_logits"],
                                      four_ranks[0][arch]["prompt_logits"])


def test_tp_cli_serves_the_same_tokens(four_ranks):
    (_, _), (_, jax_tokens) = _reference("qwen3_0_6b")
    for res in four_ranks:
        np.testing.assert_array_equal(res["cli_tokens"], jax_tokens)
