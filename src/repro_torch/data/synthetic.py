"""Synthetic class-structured stand-ins for MNIST / FashionMNIST / CIFAR-10
(PyTorch port of ``repro.data.synthetic``).

Each of the 10 classes is a Gaussian around a smooth random prototype
image; the noise scale sets the difficulty.  Draws follow the JAX package's
PRNG order, so both packages make the same dataset from the same seed.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import rng

N_CLASSES = 10

# name -> (H, W, C, noise_scale, n_train, n_test)
DATASETS = {
    "mnist": (28, 28, 1, 3.0, 4000, 1000),
    "fashionmnist": (28, 28, 1, 4.0, 4000, 1000),
    "cifar10": (32, 32, 3, 5.5, 4000, 1000),
}


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: torch.Tensor   # [n, H, W, C] float32
    y_train: torch.Tensor   # [n] int32
    x_test: torch.Tensor
    y_test: torch.Tensor

    @property
    def n_train(self) -> int:
        return self.x_train.shape[0]


def _box_blur(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.convolve(v, ones(5)/5, mode="same")`` along ``dim``: the mean
    of the 5-sample window, zero-padded at the edges."""
    n = x.shape[dim]
    pad = [0, 0] * (x.dim() - 1 - dim) + [2, 2]
    xp = torch.nn.functional.pad(x, pad)
    k = torch.tensor(1.0 / 5.0, dtype=x.dtype, device=x.device)
    acc = xp.narrow(dim, 0, n) * k
    for j in range(1, 5):
        acc = acc + xp.narrow(dim, j, n) * k
    return acc


def _smooth_prototypes(key: torch.Tensor, h: int, w: int,
                       c: int) -> torch.Tensor:
    """[10, H, W, C] low-frequency class prototypes (blurred white noise)."""
    raw = rng.normal(key, (N_CLASSES, h, w, c))
    for _ in range(3):                  # separable 5-tap box blur, x3
        raw = _box_blur(_box_blur(raw, 1), 2)
    std = raw.std(dim=(1, 2, 3), keepdim=True, correction=0)
    return raw / torch.clamp(std, min=1e-6) * 2.0


def _sample_split(key: torch.Tensor, protos: torch.Tensor, n: int,
                  noise: float) -> tuple[torch.Tensor, torch.Tensor]:
    ky, kx = rng.split(key)
    labels = torch.arange(N_CLASSES, dtype=torch.int32,
                          device=key.device).repeat(n // N_CLASSES + 1)[:n]
    labels = rng.permutation(ky, labels)
    eps = rng.normal(kx, (n,) + tuple(protos.shape[1:])) * noise
    return protos[labels.long()] + eps, labels


def make_dataset(name: str, seed: int = 0, n_train: int | None = None,
                 n_test: int | None = None, device="cpu") -> Dataset:
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; choose from "
                         f"{sorted(DATASETS)}")
    h, w, c, noise, dflt_train, dflt_test = DATASETS[name]
    n_train = n_train or dflt_train
    n_test = n_test or dflt_test
    kp, ktr, kte = rng.split(rng.PRNGKey(seed, device=device), 3).unbind(0)
    protos = _smooth_prototypes(kp, h, w, c)
    x_tr, y_tr = _sample_split(ktr, protos, n_train, noise)
    x_te, y_te = _sample_split(kte, protos, n_test, noise)
    return Dataset(name=name, x_train=x_tr, y_train=y_tr,
                   x_test=x_te, y_test=y_te)
