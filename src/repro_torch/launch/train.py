"""LM training driver (PyTorch port of ``repro.launch.train``): any of the
ten configs, reduced or full width, on the Markov token corpus.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch olmo-1b --steps 5

Runs on CUDA by default (``--device cpu`` to run on the CPU; without
either it raises).  The loop is JAX's: weights from ``PRNGKey(0)``, AdamW
(weight decay 0.01) on a cosine schedule with 10 warmup steps,
``clip_by_global_norm(1.0)``, batches from ``token_batches(1, vocab, B, T,
steps, top=8)``, a line every 10 steps and the last, and an optional
checkpoint.  Like JAX's, it feeds tokens only: Whisper and Qwen2-VL get no
audio or patch inputs.  On the card the forward and backward of kernels
7, 8 and 9 (attention, RMSNorm, the Mamba2 SSD scan) are hand-written
kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

from repro_torch import optim, resolve_device, rng
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.data import token_batches
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import n_params


def make_step(cfg: ModelConfig, opt: optim.Optimizer):
    """The training step ``(params, opt_state, batch) -> (params,
    opt_state, loss)``: the loss's gradient clipped to global norm 1, then
    one optimizer update."""
    def step(params, opt_state, batch):
        (loss, _), grads = api.value_and_grad(params, cfg, batch)
        grads = optim.clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optim.apply_updates(params, updates), opt_state, loss
    return step


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt: optim.Optimizer
    opt_state: object
    losses: list[float]
    step_s: list[float]           # wall seconds of each step, synchronised


def train(cfg: ModelConfig, steps: int, batch: int, seq: int, lr: float,
          device, log=print) -> TrainResult:
    dev = resolve_device(device)
    params = api.init_params(rng.PRNGKey(0, device=dev), cfg)
    opt = optim.adamw(optim.cosine_warmup_schedule(lr, 10, steps),
                      weight_decay=0.01)
    opt_state = opt.init(params)
    step = make_step(cfg, opt)
    log(f"arch={cfg.name} params={n_params(params):,} "
        f"uniform nll={math.log(cfg.vocab):.3f}")
    losses, step_s = [], []
    t0 = time.time()
    for i, b in enumerate(token_batches(1, cfg.vocab, batch, seq, steps,
                                        top=8, device=dev)):
        t1 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, b)
        losses.append(float(loss))      # synchronises with the card
        step_s.append(time.perf_counter() - t1)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:4d} loss={losses[-1]:.3f} "
                f"({time.time() - t0:.0f}s)")
    return TrainResult(params, opt, opt_state, losses, step_s)


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    choices=sorted(ALIASES) + ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-size", dest="reduced", action="store_false")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = train(cfg, args.steps, args.batch, args.seq, args.lr, dev)
    if args.ckpt:
        save_pytree(args.ckpt, res.params, step=args.steps)
        print(f"saved {args.ckpt}")
    return res.losses


if __name__ == "__main__":
    main()
