"""repro_torch's tensor-parallel LM (``launch.sharding``'s LM rules,
``launch.mesh.smoke_mesh``, ``models.parallel``) against the JAX package's
rules and live runs, and against the unsharded port.

* The rules: for each of the ten configs at full width, the port's
  ``param_pspecs`` on a ``meta`` tree equals JAX's on
  ``jax.eval_shape(init_params)`` leaf for leaf at model sizes 1, 2, 4, 8
  and 16; ``batch_pspecs`` at data 1 and 2; ``cache_pspecs`` in all four
  ``cache_seq_shard`` modes.  The mesh is a stand-in carrying
  ``axis_names``, ``shape`` and ``devices.shape``.  JAX's spec of a
  stacked MoE shared expert is pinned at deepseek-v2's 59 stacked layers
  (replicated) and at 8 (the layer axis sharded); the executor keeps it
  whole at both (``parallel.placement``).
* Local configs at full width: qwen3-moe-30b-a3b, qwen2-vl-7b and
  deepseek-v2-236b's heads, experts a rank, ``d_ff_dense`` and the shared
  width; mamba2-2.7b (everything whole but the vocab), zamba2-1.2b (the
  shared block's heads and ``d_ff`` split, the SSM fields whole) and
  whisper-tiny (heads and ``d_ff`` split, ``frontend_proj`` a column
  block); their leaves' shapes on a rank.  Zamba2's top-level
  ``shared/*`` block takes JAX's split while ``moe/shared/*`` stays whole.
* A world of one, in this process: a (1, 1) mesh serves the four dense
  configs, the three MoE / VLM runs and the SSM, hybrid and
  encoder-decoder runs bit-equal to the unsharded port.  Each model rank
  of the job's runs, in this process: its init hashes only its blocks
  and gets ``shard_params`` of the whole init.
* Refusals: a model axis that does not divide ``n_kv_heads`` (reduced
  deepseek-67b has KV = 1; whisper-tiny's 6 at model 4, zamba2-1.2b's 32
  at 64), the padded vocab (mamba2-2.7b's 50,432 at 3) or ``n_experts``,
  a ``--mesh`` of several ranks without torchrun.
* One four-rank ``torchrun`` job (``tests/_torch_tp_job.py``, gloo on the
  CPU), in float32: reduced qwen3-0.6b at mesh (2, 2) and reduced olmo-1b
  at (1, 4); qwen3-moe and qwen2-vl (with patches) at (2, 2), each
  reduced with two KV heads; deepseek-v2 reduced at three layers with
  the gather dispatch at (2, 2); reduced mamba2 at (1, 4), reduced zamba2
  at four layers (two groups) at (2, 2) and reduced whisper (with audio
  frames) at (2, 2).  Each rank's weights are its blocks of the
  unsharded init, bit for bit, the shared experts and the SSM layers
  whole.  Prefill logits are within 1e-5 of the largest magnitude of the
  unsharded port's and within 1e-4 of live JAX
  ``repro.models.api.prefill_fn``'s; the residual stream the final norm
  takes is bit-equal on the model ranks of a data group.  The 8 greedy
  decode tokens equal JAX's (``examples/serve_decode.py``'s loop) and
  are the same on every rank, through ``serve(mesh=)`` and the ``--mesh``
  CLI (qwen3-0.6b, deepseek-v2 and zamba2).
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
MOE_VLM = ["qwen3_moe_30b_a3b", "qwen2_vl_7b", "deepseek_v2_236b"]
SSM_AUDIO = ["mamba2_2_7b", "zamba2_1_2b", "whisper_tiny"]
MODEL_SIZES = [1, 2, 4, 8, 16]
MODES = ["none", "model", "dp_model", "auto"]
CACHE_MESHES = [(1, 1), (2, 2), (2, 8), (1, 16)]


def _mesh(data: int, model: int, model_rank: int = 0):
    """A mesh stand-in both packages' rules read (and a rank of it, for
    ``models.parallel``)."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape=(data, model),
                                 devices=np.empty((data, model)),
                                 data=data, model=model, data_rank=0,
                                 model_rank=model_rank)


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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


@pytest.mark.parametrize("n_layers, want", [(60, (None, None, None)),
                                             (9, ("model", None, None))])
def test_jax_reads_a_stacked_shared_experts_layer_axis(n_layers, want):
    """JAX's rule takes a stacked ``moe/shared`` leaf's layer axis for the
    expert axis: replicated at deepseek-v2's 59 stacked layers (4 does
    not divide them), the layer axis sharded at 8.  The port's rule is
    JAX's; the executor keeps the leaf whole at either depth."""
    jc = dataclasses.replace(j_get_config("deepseek_v2_236b"),
                             n_layers=n_layers)
    shapes = jax.eval_shape(lambda: j_api.init_params(jax.random.PRNGKey(0),
                                                      jc))
    specs = j_sharding.param_pspecs(jc, shapes, _mesh(1, 4))
    for leaf in ("gate", "up", "down"):
        path = ("layers", "moe", "shared", leaf)
        shape = tuple(shapes["layers"]["moe"]["shared"][leaf].shape)
        assert shape[0] == n_layers - 1
        assert tuple(specs["layers"]["moe"]["shared"][leaf]) == want
        assert sharding._rule(path, shape, 4) == want
        assert parallel.placement(path, shape, 4) == (None, None, None)
        # one drawn layer: JAX's rule splits [d, f] as a dense MLP's
        assert parallel.placement(path, shape[1:], 4) == (None, None)


# ----------------------------------------------------------- local configs --
@pytest.mark.parametrize("arch, model, want", [
    ("qwen3_moe_30b_a3b", 4, dict(n_heads=8, n_kv_heads=1, head_dim=128,
                                  n_experts=128, d_ff_expert=768,
                                  per_rank=32)),
    ("qwen2_vl_7b", 2, dict(n_heads=14, n_kv_heads=2, head_dim=128,
                            d_ff=9472, frontend_dim=1280, n_patches=1024)),
    ("deepseek_v2_236b", 4, dict(n_heads=32, n_kv_heads=32, d_ff_dense=3072,
                                 n_experts=160, d_ff_expert=1536,
                                 n_shared_experts=2, per_rank=40,
                                 q_lora_rank=1536, kv_lora_rank=512))])
def test_local_config_of_the_moe_and_vlm_configs(arch, model, want):
    """A rank's fields at full width, its expert block, and the shapes of
    its leaves (a ``meta`` init): heads, the dense first layer's ``d_ff``
    and the patch projection's columns split, the experts a block a
    rank, the shared experts and MLA's down projections whole."""
    cfg = get_config(arch)
    per_rank = want.pop("per_rank", None)
    for r in range(model):
        lcfg = parallel.local_config(cfg, _mesh(1, model, r))
        for name, value in want.items():
            assert getattr(lcfg, name) == value, name
        if per_rank:
            assert parallel.expert_block(lcfg) == (r * per_rank, per_rank)
    p = api.init_params(rng.PRNGKey(0, device="meta"), lcfg)
    layers_, n = p["layers"], cfg.n_layers - cfg.first_k_dense
    d = cfg.d_model
    assert p["embed"]["table"].shape == (cfg.padded_vocab // model, d)
    if cfg.is_moe:
        f = cfg.d_ff_expert
        assert layers_["moe"]["gate"].shape == (n, per_rank, d, f)
        assert layers_["moe"]["down"].shape == (n, per_rank, f, d)
        assert layers_["moe"]["router"].shape == (n, d, cfg.n_experts)
    if cfg.n_shared_experts:
        width = cfg.n_shared_experts * cfg.d_ff_expert
        assert layers_["moe"]["shared"]["gate"].shape == (n, d, width)
        assert layers_["moe"]["shared"]["down"].shape == (n, width, d)
    if cfg.attention == "mla":
        h = cfg.n_heads // model
        attn = layers_["attn"]
        assert attn["wq_a"].shape == (n, d, cfg.q_lora_rank)
        assert attn["wkv_a"].shape == (n, d, cfg.kv_lora_rank
                                       + cfg.qk_rope_head_dim)
        assert attn["wq_b"].shape == (n, cfg.q_lora_rank, h * (
            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
        assert attn["wkv_b"].shape == (n, cfg.kv_lora_rank, h * (
            cfg.qk_nope_head_dim + cfg.v_head_dim))
        assert attn["wo"].shape == (n, h * cfg.v_head_dim, d)
        dense = p["first_dense"][0]
        assert dense["mlp"]["gate"].shape == (d, cfg.d_ff_dense // model)
        assert dense["mlp"]["down"].shape == (cfg.d_ff_dense // model, d)
        assert dense["attn"]["wo"].shape == (h * cfg.v_head_dim, d)
    if cfg.frontend == "vision":
        assert p["patch_proj"].shape == (cfg.frontend_dim, d // model)
    cache = api.init_cache(lcfg, 2, 16, device="meta")
    if cfg.attention == "mla":      # the latent cache whole on every rank
        assert cache["layers"]["ckv"].shape == (n, 2, 16, cfg.kv_lora_rank)
    else:
        assert cache["layers"]["k"].shape == (n, 2, 16, lcfg.n_kv_heads,
                                              cfg.head_dim)


@pytest.mark.parametrize("arch, model, want", [
    ("mamba2_2_7b", 4, dict(n_heads=1, n_kv_heads=1, d_ff=0)),
    ("zamba2_1_2b", 4, dict(n_heads=8, n_kv_heads=8, d_ff=2048,
                            head_dim=64)),
    ("whisper_tiny", 2, dict(n_heads=3, n_kv_heads=3, d_ff=768,
                             head_dim=64))])
def test_local_config_of_the_ssm_hybrid_and_audio_configs(arch, model, want):
    """A rank's fields at full width and the shapes of its leaves (a
    ``meta`` init and cache): the SSM fields and every SSM leaf whole (an
    attention-free config's head fields too), zamba2's shared block and
    whisper's blocks split as dense blocks, ``frontend_proj`` a column
    block, the vocab a row block."""
    cfg = get_config(arch)
    lcfg = parallel.local_config(cfg, _mesh(1, model, model - 1))
    for name, value in want.items():
        assert getattr(lcfg, name) == value, name
    for name in ("d_model", "d_inner", "ssm_heads", "ssm_state",
                 "ssm_head_dim", "padded_vocab", "n_layers", "n_enc_layers",
                 "frontend_dim"):
        assert getattr(lcfg, name) == getattr(cfg, name), name
    p = api.init_params(rng.PRNGKey(0, device="meta"), lcfg)
    full = api.init_params(rng.PRNGKey(0, device="meta"), cfg)
    d = cfg.d_model
    assert p["embed"]["table"].shape == (cfg.padded_vocab // model, d)
    if "layers" in p:                 # the SSM stack whole on every rank
        for got, whole in zip(tree_leaves(p["layers"]),
                              tree_leaves(full["layers"])):
            assert got.shape == whole.shape
    if cfg.arch_type == "hybrid":
        h = cfg.n_heads // model * cfg.head_dim
        shared = p["shared"]
        assert shared["attn"]["wq"].shape == (d, h)
        assert shared["attn"]["wk"].shape == (d, h)
        assert shared["attn"]["wo"].shape == (h, d)
        assert shared["mlp"]["gate"].shape == (d, cfg.d_ff // model)
        assert shared["mlp"]["down"].shape == (cfg.d_ff // model, d)
    if cfg.encoder_decoder:
        h = cfg.n_heads // model * cfg.head_dim
        assert p["frontend_proj"].shape == (cfg.frontend_dim, d // model)
        for stack, n in (("enc_layers", cfg.n_enc_layers),
                         ("dec_layers", cfg.n_layers)):
            for attn in ("attn", "self_attn", "cross_attn"):
                if attn in p[stack]:
                    assert p[stack][attn]["wv"].shape == (n, d, h)
                    assert p[stack][attn]["wo"].shape == (n, h, d)
            assert p[stack]["mlp"]["up"].shape == (n, d, cfg.d_ff // model)
    cache = api.init_cache(lcfg, 2, 16, device="meta")
    whole = api.init_cache(cfg, 2, 16, device="meta")
    if cfg.arch_type in ("ssm", "hybrid"):
        for leaf in ("conv", "state"):
            assert cache["layers"][leaf].shape == whole["layers"][leaf].shape
    if cfg.arch_type == "hybrid":
        assert cache["shared"]["k"].shape == (
            cfg.n_layers // cfg.shared_attn_every, 2, 16,
            cfg.n_kv_heads // model, cfg.head_dim)
    if cfg.encoder_decoder:
        assert cache["memory"].shape == whole["memory"].shape
        assert cache["k"].shape == (cfg.n_layers, 2, 16,
                                    cfg.n_kv_heads // model, cfg.head_dim)


def test_zamba2_shared_block_is_split_and_moe_shared_is_whole():
    """"shared" names two things: zamba2's top-level shared attention
    block, which JAX's rule splits as a dense block (and so does the
    executor), and MoE's shared expert (``moe/shared/*``), which the
    executor keeps whole (:func:`test_jax_reads_a_stacked_shared_experts_
    layer_axis`)."""
    want_shape, _ = _params_shape("zamba2_1_2b")
    specs = j_sharding.param_pspecs(j_get_config("zamba2_1_2b"), want_shape,
                                    _mesh(1, 4))
    for sub, leaf, spec in (("attn", "wq", (None, "model")),
                            ("attn", "wo", ("model", None)),
                            ("mlp", "gate", (None, "model")),
                            ("mlp", "down", ("model", None))):
        path = ("shared", sub, leaf)
        shape = tuple(want_shape["shared"][sub][leaf].shape)
        assert tuple(specs["shared"][sub][leaf]) == spec
        assert parallel.placement(path, shape, 4) == spec
    _, moe_shape = _params_shape("deepseek_v2_236b")
    for leaf, w in moe_shape["layers"]["moe"]["shared"].items():
        path = ("layers", "moe", "shared", leaf)
        assert parallel.placement(path, tuple(w.shape), 4) == (None,) * 3
        assert parallel.placement(path, tuple(w.shape[1:]), 4) == (None,) * 2


# ------------------------------------------------------- a world of one --
@pytest.mark.parametrize("arch", DENSE + MOE_VLM + SSM_AUDIO)
def test_world_of_one_is_the_unsharded_port(arch):
    """A (1, 1) mesh: the local config draws the same weights, and the
    prefill logits and the served tokens are bit-equal."""
    cfg = job.config(arch)
    mesh = smoke_mesh(1, 1, device="cpu")
    lcfg = parallel.local_config(cfg, mesh)
    assert lcfg.head_dim == cfg.head_dim and lcfg.n_heads == cfg.n_heads
    want_p = api.init_params(rng.PRNGKey(0), cfg)
    got_p = api.init_params(rng.PRNGKey(0), lcfg)
    for g, w in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert torch.equal(g, w)
    batch = _torch_batch(job.prefill_batch(cfg))
    assert torch.equal(api.prefill_fn(got_p, lcfg, batch),
                       api.prefill_fn(want_p, cfg, batch))
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


@pytest.mark.parametrize("arch, model, match", [
    ("whisper_tiny", 4, "divide n_kv_heads = 6"),
    ("mamba2_2_7b", 3, "divide the padded vocab = 50432"),
    ("zamba2_1_2b", 64, "divide n_kv_heads = 32"),
    # 64 divides its heads, d_ff, d_ff_dense and vocab
    ("deepseek_v2_236b", 64, "divide n_experts = 160")])
def test_refuses_what_the_executor_does_not_serve(arch, model, match):
    """Full-width configs on a model axis that does not divide their KV
    heads (whisper-tiny's 6, zamba2-1.2b's 32), their padded vocab
    (mamba2-2.7b, attention-free, has no heads to check) or their
    experts."""
    with pytest.raises(ValueError, match=match):
        parallel.local_config(get_config(arch), _mesh(1, model))


def test_refuses_a_moe_batch_split_unevenly():
    """A MoE layer routes the data group's rows together, so a batch that
    does not divide over the data axis is refused."""
    cfg = job.config("qwen3_moe_30b_a3b")
    with pytest.raises(ValueError, match="does not divide over a data axis"):
        parallel.batch_rows(cfg, {"tokens": torch.zeros(3, 4)},
                            _mesh(2, 2))
    rows = parallel.batch_rows(cfg, {"tokens": torch.arange(8)[:, None]},
                               _mesh(2, 2))
    assert rows["tokens"].shape == (4, 1)


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
    prefill logits and greedy tokens) of ``arch``'s run config."""
    cfg = job.config(arch)
    batch = job.prefill_batch(cfg)
    params = api.init_params(rng.PRNGKey(0), cfg)
    port = (api.prefill_fn(params, cfg, _torch_batch(batch)).numpy(),
            serve_decode.serve(cfg, arch, device="cpu", params=params,
                               **job.SERVE).tokens.numpy())
    return port, _jax_reference(job.config(arch, j_get_config), batch)


def _jax_reference(jc, batch):
    """Live JAX's prefill logits of ``batch`` and greedy tokens of
    ``examples/serve_decode.py``'s loop, for the config ``jc``."""
    b, prompt_len, gen_len = (job.SERVE[k] for k in
                              ("batch", "prompt_len", "gen_len"))
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(0)
        jp = j_api.init_params(key, jc)
        cache = j_api.init_cache(jc, b, prompt_len + gen_len)
        prompt = jax.random.randint(key, (b, prompt_len), 0, jc.vocab)
    want_logits = np.asarray(j_api.prefill_fn(jp, jc, batch))
    decode = jax.jit(lambda p, c, t, pos: j_api.decode_step(p, jc, c, t, pos))
    for t in range(prompt_len):
        logits, cache = decode(jp, cache, prompt[:, t:t + 1], jnp.int32(t))
    want_tokens = []
    for t in range(prompt_len, prompt_len + gen_len):
        nxt = jnp.argmax(logits[:, :jc.vocab], axis=-1)[:, None]
        want_tokens.append(np.asarray(nxt))
        logits, cache = decode(jp, cache, nxt.astype(jnp.int32),
                               jnp.int32(t))
    return want_logits, np.concatenate(want_tokens, axis=1)


RUNS = dict(job.RUNS)


def test_four_ranks_lay_the_mesh_out_data_major(four_ranks):
    for r, res in enumerate(four_ranks):
        assert (res["rank"], res["world_size"]) == (r, job.WORLD)
        for arch, (data, model) in RUNS.items():
            assert (res[arch]["data_rank"], res[arch]["model_rank"]) == \
                (r // model, r % model)


@pytest.mark.parametrize("arch", list(RUNS))
def test_each_rank_holds_its_blocks_of_the_init(four_ranks, arch):
    """Each rank's draw of its blocks is exactly ``shard_params`` of the
    unsharded init (a MoE shared expert whole); the batch rows follow
    ``batch_pspecs``."""
    cfg = job.config(arch)
    data, model = RUNS[arch]
    full = api.init_params(rng.PRNGKey(0), cfg)
    batch = job.prefill_batch(cfg)
    for r, res in enumerate(four_ranks):
        want = parallel.shard_params(full, _mesh(data, model, r % model))
        got = res[arch]["params"]
        assert [w.shape for w in tree_leaves(want)] == [
            np.shape(g) for g in jax.tree_util.tree_leaves(got)]
        for g, w in zip(jax.tree_util.tree_leaves(got), tree_leaves(want)):
            np.testing.assert_array_equal(g, w.numpy())
        if cfg.n_shared_experts:
            for leaf, w in full["layers"]["moe"]["shared"].items():
                np.testing.assert_array_equal(
                    got["layers"]["moe"]["shared"][leaf], w.numpy())
        n = job.B // data
        assert sorted(res[arch]["rows"]) == sorted(batch)
        for k, v in batch.items():
            np.testing.assert_array_equal(
                res[arch]["rows"][k], v[(r // model) * n:(r // model + 1) * n])
        assert res[arch]["local_logits_shape"] == (n, cfg.padded_vocab
                                                   // model)


@pytest.mark.parametrize("arch", list(RUNS))
def test_model_ranks_hold_the_same_stream(four_ranks, arch):
    """The residual stream the final norm takes (every SSM layer's output
    runs into it) is bit-equal on the model ranks of a data group: each
    runs the replicated layers on the same rows, and the row-parallel
    sums and the vocab-parallel lookup give every rank the same numbers."""
    model = RUNS[arch][1]
    for r, res in enumerate(four_ranks):
        first = four_ranks[r - r % model][arch]["stream"]
        np.testing.assert_array_equal(res[arch]["stream"], first)
        assert res[arch]["stream"].shape[-1] == job.config(arch).d_model


@pytest.mark.parametrize("arch", list(RUNS))
def test_a_rank_draws_its_blocks_alone(arch):
    """In this process, for each model rank of the run's mesh: the local
    config's init hashes only the rank's blocks and gets ``shard_params``
    of the unsharded init bit for bit (on ``meta``, their shapes)."""
    cfg = job.config(arch)
    data, model = RUNS[arch]
    full = api.init_params(rng.PRNGKey(0), cfg)
    for r in range(model):
        mesh = _mesh(data, model, r)
        lcfg = parallel.local_config(cfg, mesh)
        want = tree_leaves(parallel.shard_params(full, mesh))
        got = tree_leaves(api.init_params(rng.PRNGKey(0), lcfg))
        meta = tree_leaves(api.init_params(rng.PRNGKey(0, device="meta"),
                                           lcfg))
        assert [m.shape for m in meta] == [w.shape for w in want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_deepseek_v2_run_shards_jax_s_shared_layer_axis():
    """The deepseek-v2 run is a depth where JAX's stacked shared-expert
    spec shards the layer axis at model 2 (two stacked MoE layers), while
    the executor keeps the leaf whole: its outputs' agreement with the
    unsharded port and JAX (the tests above) does not rest on it."""
    jc = job.config("deepseek_v2_236b", j_get_config)
    shapes = jax.eval_shape(lambda: j_api.init_params(jax.random.PRNGKey(0),
                                                      jc))
    model = RUNS["deepseek_v2_236b"][1]
    specs = j_sharding.param_pspecs(jc, shapes, _mesh(1, model))
    for leaf, spec in specs["layers"]["moe"]["shared"].items():
        assert tuple(spec) == ("model", None, None), leaf
        shape = shapes["layers"]["moe"]["shared"][leaf].shape
        assert parallel.placement(("layers", "moe", "shared", leaf), shape,
                                  model) == (None, None, None)


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


@pytest.mark.parametrize("arch", list(job.CLIS))
def test_tp_cli_serves_the_same_tokens(four_ranks, arch):
    """``serve_decode --mesh 2,2`` of the CLI's ``--reduced`` config (no
    EDITS): the same greedy tokens as live JAX on every rank."""
    jc = j_get_config(arch).reduced()
    batch = job.prefill_batch(jc)
    _, jax_tokens = (_reference(arch)[1] if not job.EDITS.get(arch)
                     else _jax_reference(jc, batch))
    for res in four_ranks:
        np.testing.assert_array_equal(res["cli_tokens"][arch], jax_tokens)
