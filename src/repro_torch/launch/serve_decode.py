"""Batched serving loop of the PyTorch port (counterpart of
``examples/serve_decode.py``): fill the decode cache by stepping the prompt
through it, then decode greedily.  Any of the ten configs (ids or aliases
of ``repro_torch.configs``); ``--sliding-window W`` serves it with a
W-token attention window, as the JAX example's windowed run does.

    PYTHONPATH=src python -m repro_torch.launch.serve_decode \
        --config qwen3_0_6b --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve_decode \
        --config qwen3_0_6b --device cpu --reduced --sliding-window 16
    PYTHONPATH=src python -m repro_torch.launch.serve_decode \
        --config zamba2_1_2b --batch 4 --prompt-len 512 --gen-len 32
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \
        repro_torch.launch.serve_decode --config qwen3_0_6b --reduced \
        --device cpu --mesh 2,2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \
        repro_torch.launch.serve_decode --config deepseek_v2_236b \
        --reduced --device cpu --mesh 2,2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \
        repro_torch.launch.serve_decode --config mamba2_2_7b --reduced \
        --device cpu --mesh 1,4

Runs on CUDA by default (``--device cpu`` to run on the CPU) and raises
without it.  The weights and the prompt both come from ``PRNGKey(0)``, as
in the JAX example, so the port serves the same model the same tokens.
An encoder-decoder (Whisper) decodes against the cache's zero encoder
memory, as the JAX example does (ROADMAP.md C.15).

``--mesh DATA,MODEL`` serves any of the ten configs tensor-parallel over
``DATA x MODEL`` ranks (``torchrun``, gloo;
:func:`repro_torch.launch.mesh.smoke_mesh`), as JAX's specs place it: the
dense family (qwen3, deepseek-67b, olmo), qwen2-vl, qwen3-moe-30b-a3b (a
rank its block of the experts), deepseek-v2-236b (MLA's heads and the
experts split), mamba2-2.7b (its SSM layers whole on every rank, the
vocab split), zamba2-1.2b (the SSM layers whole, the shared attention
block split as a dense block) and whisper-tiny (encoder, decoder and
cross attention split as dense blocks).  A model axis that does not
divide the KV heads, heads, ``d_ff``, padded vocab or experts is refused.
A rank draws its blocks alone, takes its data rank's batch rows (a MoE
batch must divide over them), and every rank ends with the whole batch's
tokens, those of a model group being one greedy pick.  A mesh above one
rank refuses to run without torchrun.  Rank 0 alone prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device, rng
from repro_torch.configs import get_config
from repro_torch.launch.mesh import smoke_mesh
from repro_torch.models import api, parallel
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # [B, gen_len] the greedy tokens
    prompt: torch.Tensor          # [B, prompt_len] int32
    prompt_logits: torch.Tensor   # [B, V] logits after the last prompt step
    fill_s: float                 # wall seconds stepping the prompt
    decode_s: float               # wall seconds of the greedy steps
    tok_per_s: float              # batch * (prompt_len + gen_len) / total


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, label: str, batch: int = 4, prompt_len: int = 32,
          gen_len: int = 16, device=None, params=None,
          mesh=None) -> ServeResult:
    """Serve one batch; ``params`` defaults to ``api.init_params`` of
    ``PRNGKey(0)`` (pass the same weights to skip drawing them again).

    With a ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`) this rank runs
    ``parallel.local_config(cfg, mesh)`` on its batch rows (``params``
    then its blocks), on ``device`` or else the mesh's; the result holds
    the whole batch."""
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device)
    run_cfg = cfg if mesh is None else parallel.local_config(cfg, mesh)
    key = rng.PRNGKey(0, device=dev)
    if params is None:
        params = api.init_params(key, run_cfg)
    max_len = prompt_len + gen_len
    prompt = rng.randint(key, (batch, prompt_len), 0, cfg.vocab)
    rows = parallel.batch_rows(cfg, prompt, mesh)
    cache = api.init_cache(run_cfg, rows.shape[0], max_len, device=dev)

    # prefill by stepping the prompt through the cache, as the JAX example
    # does (api.prefill_fn is the one-shot prompt forward)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = api.decode_step(params, run_cfg, cache,
                                        rows[:, t:t + 1], t)
    prompt_logits = logits
    _sync(dev)
    t1 = time.perf_counter()
    toks = []
    for t in range(prompt_len, max_len):
        nxt = parallel.greedy(run_cfg, logits)
        toks.append(nxt)
        logits, cache = api.decode_step(params, run_cfg, cache,
                                        nxt.to(torch.int32), t)
    _sync(dev)
    t2 = time.perf_counter()
    out = parallel.gather_rows(cfg, torch.cat(toks, dim=1), batch, mesh)
    prompt_logits = parallel.gather_rows(
        cfg, parallel.gather_columns(run_cfg, prompt_logits), batch, mesh)
    tok_per_s = batch * max_len / (t2 - t0)
    if mesh is None or mesh.rank == 0:
        print(f"{label:28s} {tok_per_s:8.1f} tok/s   "
              f"sample: {out[0, :8].tolist()}")
    return ServeResult(tokens=out, prompt=prompt, prompt_logits=prompt_logits,
                       fill_s=t1 - t0, decode_s=t2 - t1, tok_per_s=tok_per_s)


def _mesh_shape(text: str) -> tuple[int, int]:
    parts = text.split(",")
    if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
        raise argparse.ArgumentTypeError(f"takes DATA,MODEL, got {text!r}")
    return int(parts[0]), int(parts[1])


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="zamba2_1_2b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test variant (2 layers, d<=256)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="parameter dtype (default: the config's)")
    ap.add_argument("--sliding-window", type=int, default=None,
                    help="attention window in tokens (default: the "
                         "config's, none)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    type=_mesh_shape, help="serve over a (data, model) mesh of DATA x MODEL "
                         "ranks (torchrun; default: one process, no mesh)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=args.sliding_window)
    mesh = (None if args.mesh is None
            else smoke_mesh(*args.mesh, device=args.device))
    try:
        return serve(cfg, cfg.name, batch=args.batch,
                     prompt_len=args.prompt_len, gen_len=args.gen_len,
                     device=dev if mesh is None else mesh.device, mesh=mesh)
    finally:
        if mesh is not None:
            mesh.close()


if __name__ == "__main__":
    main()
