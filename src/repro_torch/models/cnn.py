"""The paper's FL classification model: a small CNN (PyTorch port of
``repro.models.cnn``).

conv3x3(c1) -> relu -> maxpool2 -> conv3x3(c2) -> relu -> maxpool2
-> dense(h) -> relu -> dense(10)

Parameters are a plain dict of tensors in the JAX layouts (HWIO conv
weights, [in, out] dense weights, NHWC images), so the two packages can
share weights (:mod:`repro_torch.interop`).  :func:`apply_clients` runs a
whole fleet at once: every leaf carries a leading ``[N]`` client axis and
each contraction is one ``torch.bmm`` over the clients, the plain batched
products XLA computed outside any Pallas kernel in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import rng
from repro_torch.tree import Params, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    height: int = 28
    width: int = 28
    channels: int = 1
    c1: int = 8
    c2: int = 16
    hidden: int = 32
    n_classes: int = 10

    @property
    def flat_dim(self) -> int:
        return (self.height // 4) * (self.width // 4) * self.c2

    @staticmethod
    def paper_scale(height=28, width=28, channels=1) -> "CNNConfig":
        return CNNConfig(height=height, width=width, channels=channels,
                         c1=16, c2=32, hidden=64)


def init(key: torch.Tensor, cfg: CNNConfig) -> Params:
    k1, k2, k3, k4 = rng.split(key, 4).unbind(0)
    dev = key.device

    def he(k, shape, fan_in):
        scale = torch.sqrt(torch.tensor(2.0 / fan_in, dtype=torch.float32,
                                        device=dev))
        return rng.normal(k, shape) * scale

    def zeros(n):
        return torch.zeros((n,), device=dev)

    return {
        "conv1": {"w": he(k1, (3, 3, cfg.channels, cfg.c1), 9 * cfg.channels),
                  "b": zeros(cfg.c1)},
        "conv2": {"w": he(k2, (3, 3, cfg.c1, cfg.c2), 9 * cfg.c1),
                  "b": zeros(cfg.c2)},
        "fc1": {"w": he(k3, (cfg.flat_dim, cfg.hidden), cfg.flat_dim),
                "b": zeros(cfg.hidden)},
        "fc2": {"w": he(k4, (cfg.hidden, cfg.n_classes), cfg.hidden),
                "b": zeros(cfg.n_classes)},
    }


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of x [N, B, H, W, Cin] with per-client w [N, 3, 3, Cin,
    Cout] via im2col: 9 shifted slices, patch order (kh, kw, cin), one bmm."""
    n, bsz, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape[1:]
    xp = torch.nn.functional.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    patches = torch.cat([xp[:, :, i:i + h, j:j + wd, :]
                         for i in range(kh) for j in range(kw)], dim=-1)
    out = torch.bmm(patches.reshape(n, bsz * h * wd, kh * kw * cin),
                    w.reshape(n, kh * kw * cin, cout)) + b[:, None, :]
    return out.reshape(n, bsz, h, wd, cout)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool by reshape-and-reduce (odd edges dropped)."""
    n, bsz, h, w, c = x.shape
    x = x[:, :, : h - h % 2, : w - w % 2, :]
    return x.reshape(n, bsz, h // 2, 2, w // 2, 2, c).amax(dim=(3, 5))


def apply_clients(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-client params (leaves [N, ...]), x [N, B, H, W, C] -> logits
    [N, B, n_classes]."""
    h = torch.relu(_conv(x, params["conv1"]["w"], params["conv1"]["b"]))
    h = _maxpool2(h)
    h = torch.relu(_conv(h, params["conv2"]["w"], params["conv2"]["b"]))
    h = _maxpool2(h)
    h = h.reshape(h.shape[0], h.shape[1], -1)
    h = torch.relu(torch.bmm(h, params["fc1"]["w"])
                   + params["fc1"]["b"][:, None, :])
    return torch.bmm(h, params["fc2"]["w"]) + params["fc2"]["b"][:, None, :]


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] -> logits [B, n_classes]."""
    return apply_clients(tree_map(lambda p: p[None], params), x[None])[0]


def client_losses(params: Params, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """[N] mean cross-entropy of each client's batch (x [N, B, ...])."""
    logp = torch.log_softmax(apply_clients(params, x), dim=-1)
    return -torch.take_along_dim(logp, y.long()[..., None], dim=-1)[..., 0] \
        .mean(dim=-1)


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return client_losses(tree_map(lambda p: p[None], params), x[None],
                         y[None])[0]


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(apply(params, x), dim=-1)
    return (pred == y.long()).float().mean()


def n_params(params: Params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def model_mbit(params: Params, bits_per_param: int = 32) -> float:
    """Uplink payload S for the latency model (Eq. 5)."""
    return n_params(params) * bits_per_param / 1e6
