"""The four-rank half of tests/test_torch_tp.py: tensor-parallel serving
of reduced dense configs on the CPU over a gloo world of four ranks.

    torchrun --standalone --nproc-per-node 4 tests/_torch_tp_job.py OUT

Reduced qwen3-0.6b at mesh (2, 2) and reduced olmo-1b at (1, 4), in
float32: each rank draws its blocks of the weights, prefills its batch
rows (the whole vocab's logits gathered), serves greedily through
``serve_decode.serve(mesh=)``, then through the ``--mesh`` CLI.  Each
rank writes what it computed to ``OUT/rank{r}.pkl``.  Imports no jax:
the test process, which does, compares these with the unsharded port and
live JAX.
"""
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
from repro_torch.models import api, parallel

WORLD = 4
RUNS = (("qwen3_0_6b", (2, 2)), ("olmo_1b", (1, 4)))
B, S = 4, 16                  # the prefill batch
SERVE = dict(batch=4, prompt_len=8, gen_len=8)
CLI = ["--config", "qwen3_0_6b", "--reduced", "--device", "cpu",
       "--mesh", "2,2", "--batch", "4", "--prompt-len", "8",
       "--gen-len", "8"]


def prefill_tokens(cfg) -> np.ndarray:
    """The prefill batch's tokens [B, S] (numpy, from a seed)."""
    rs = np.random.default_rng(sum(map(ord, cfg.name)))
    return rs.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def run(arch: str, shape: tuple) -> dict:
    cfg = get_config(arch).reduced()
    mesh = smoke_mesh(*shape, device="cpu")
    lcfg = parallel.local_config(cfg, mesh)
    params = api.init_params(rng.PRNGKey(0), lcfg)
    rows = parallel.batch_rows(
        cfg, {"tokens": torch.from_numpy(prefill_tokens(cfg))}, mesh)
    local = api.prefill_fn(params, lcfg, rows)
    logits = parallel.gather_rows(
        cfg, parallel.gather_logits(lcfg, local), B, mesh)
    res = serve_decode.serve(cfg, arch, device="cpu", params=params,
                             mesh=mesh, **SERVE)
    return {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
            "params": params_to_numpy(params),
            "rows": rows["tokens"].numpy(), "local_logits_shape":
            tuple(local.shape), "logits": logits.numpy(),
            "tokens": res.tokens.numpy(),
            "prompt_logits": res.prompt_logits.numpy()}


def main(out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    res = {"rank": dist.get_rank(), "world_size": dist.get_world_size()}
    for arch, shape in RUNS:
        res[arch] = run(arch, shape)
    res["cli_tokens"] = serve_decode.main(CLI).tokens.numpy()
    dist.destroy_process_group()
    with open(out / f"rank{res['rank']}.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
