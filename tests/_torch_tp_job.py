"""The four-rank half of tests/test_torch_tp.py: tensor-parallel serving
of reduced configs on the CPU over a gloo world of four ranks.

    torchrun --standalone --nproc-per-node 4 tests/_torch_tp_job.py OUT

In float32: reduced qwen3-0.6b at mesh (2, 2) and reduced olmo-1b at
(1, 4); reduced qwen3-moe-30b-a3b (einsum dispatch) and qwen2-vl-7b (with
patch embeddings) at (2, 2), each with two KV heads (``reduced()`` keeps
one, which no model axis above 1 divides); reduced deepseek-v2-236b at
three layers (the dense first layer and two stacked MoE layers, so JAX's
stacked shared-expert spec shards the layer axis at model 2) with the
gather dispatch, at (2, 2); reduced mamba2-2.7b at (1, 4) (its SSM layers
whole on every rank); reduced zamba2-1.2b at four layers (two groups, so
the shared block is reused) at (2, 2); reduced whisper-tiny (with audio
frame embeddings) at (2, 2).  Each rank draws its blocks of the weights,
prefills its batch rows (the whole vocab's logits gathered, the residual
stream the final norm takes kept), serves greedily through
``serve_decode.serve(mesh=)``, then through the ``--mesh`` CLI
(qwen3-0.6b, deepseek-v2 and zamba2).  Each rank writes what it computed
to ``OUT/rank{r}.pkl``.  Imports no jax: the test process, which
does, compares these with the unsharded port and live JAX.
"""
import contextlib
import dataclasses
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.interop import params_to_numpy
from repro_torch.launch import serve_decode
from repro_torch.launch.mesh import smoke_mesh
from repro_torch.models import api, layers, parallel

WORLD = 4
RUNS = (("qwen3_0_6b", (2, 2)), ("olmo_1b", (1, 4)),
        ("qwen3_moe_30b_a3b", (2, 2)), ("qwen2_vl_7b", (2, 2)),
        ("deepseek_v2_236b", (2, 2)), ("mamba2_2_7b", (1, 4)),
        ("zamba2_1_2b", (2, 2)), ("whisper_tiny", (2, 2)))
# what each run changes of reduced(), in both packages alike
EDITS = {"qwen3_moe_30b_a3b": dict(n_kv_heads=2),
         "qwen2_vl_7b": dict(n_kv_heads=2),
         "deepseek_v2_236b": dict(n_layers=3, moe_dispatch="gather"),
         "zamba2_1_2b": dict(n_layers=4)}
B, S = 4, 16                  # the prefill batch
AUDIO_FRAMES = 32             # the encoder-decoder's frames a row
SERVE = dict(batch=4, prompt_len=8, gen_len=8)
CLIS = {arch: ["--config", arch, "--reduced", "--device", "cpu",
               "--mesh", "2,2", "--batch", "4", "--prompt-len", "8",
               "--gen-len", "8"] for arch in ("qwen3_0_6b",
                                              "deepseek_v2_236b",
                                              "zamba2_1_2b")}


def config(arch: str, get=get_config):
    """The run's config of ``arch``: ``reduced()`` with its EDITS, from
    ``get`` (the port's ``get_config``, or JAX's)."""
    return dataclasses.replace(get(arch).reduced(), **EDITS.get(arch, {}))


def prefill_batch(cfg) -> dict:
    """The prefill batch (numpy, from a seed): tokens [B, S], and the VLM's
    patch embeddings [B, n_patches, frontend_dim] or the encoder-decoder's
    audio frame embeddings [B, AUDIO_FRAMES, frontend_dim]."""
    rs = np.random.default_rng(sum(map(ord, cfg.name)))
    batch = {"tokens": rs.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rs.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.encoder_decoder:
        batch["audio_embeds"] = rs.standard_normal(
            (B, AUDIO_FRAMES, cfg.frontend_dim)).astype(np.float32)
    return batch


@contextlib.contextmanager
def final_streams(params):
    """The residual streams the model's final norm (``params
    ["final_norm"]``) takes, a call each, in call order."""
    inner = layers.norm_apply
    log = []

    def spy(cfg, p, x):
        if p is params["final_norm"]:
            log.append(x)
        return inner(cfg, p, x)

    layers.norm_apply = spy
    try:
        yield log
    finally:
        layers.norm_apply = inner


def run(arch: str, shape: tuple) -> dict:
    cfg = config(arch)
    mesh = smoke_mesh(*shape, device="cpu")
    lcfg = parallel.local_config(cfg, mesh)
    params = api.init_params(rng.PRNGKey(0), lcfg)
    rows = parallel.batch_rows(
        cfg, {k: torch.from_numpy(v) for k, v in prefill_batch(cfg).items()},
        mesh)
    with final_streams(params) as streams:
        local = api.prefill_fn(params, lcfg, rows)
    logits = parallel.gather_rows(
        cfg, parallel.gather_columns(lcfg, local), B, mesh)
    res = serve_decode.serve(cfg, arch, device="cpu", params=params,
                             mesh=mesh, **SERVE)
    return {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
            "params": params_to_numpy(params),
            "rows": {k: v.numpy() for k, v in rows.items()},
            "local_logits_shape": tuple(local.shape),
            "stream": streams[-1].numpy(),
            "logits": logits.numpy(), "tokens": res.tokens.numpy(),
            "prompt_logits": res.prompt_logits.numpy()}


def main(out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    res = {"rank": dist.get_rank(), "world_size": dist.get_world_size()}
    for arch, shape in RUNS:
        res[arch] = run(arch, shape)
    res["cli_tokens"] = {arch: serve_decode.main(argv).tokens.numpy()
                         for arch, argv in CLIS.items()}
    dist.destroy_process_group()
    with open(out / f"rank{res['rank']}.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
