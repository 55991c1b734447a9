"""Counter-based threefry2x32 keys that reproduce ``jax.random`` bit for bit.

The simulation is randomised end to end, and DAGSA itself draws inside its
greedy loop (the forced add), so the port can only agree with the JAX
package decision for decision if it draws the same numbers.  This module
re-implements the default ``jax.random`` implementation (threefry2x32 in
``threefry_partitionable=True`` mode, jax >= 0.5) on torch tensors:

* a key is an int64 tensor ``[..., 2]`` holding two uint32 words; every
  function vectorises over the leading key axes, so one call can serve one
  key per client per epoch;
* arithmetic runs in int64 lanes masked to 32 bits, because ``torch.uint32``
  lacks arithmetic on some backends;
* the counters of a draw of shape ``s`` are the 64-bit row-major iota of
  ``s`` split into (hi, lo) words, and the 32-bit bits are ``b1 ^ b2``.

A key on the ``meta`` device draws ``meta`` tensors of the right shapes and
dtypes without hashing anything: an init from such a key gives the
parameters' shapes alone (``roofline.report``'s parameter counts).

The legacy (non-partitionable) layout is not implemented.  Keys are explicit
and handed down every call, as in the JAX package; there is no hidden state.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block cipher (20 rounds) on broadcastable int64
    tensors holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


# Elements of one draw hashed at a time.  Element i's bits are a function of
# the key and i alone (partitionable threefry), so a draw walks its flat
# counter range in blocks of this many and returns the same numbers as in
# one piece; each block's int64 and float64 temporaries (~100 bytes a
# value) are freed before the next, which bounds a full-width init.
BLOCK = 1 << 24


def _hash(key: torch.Tensor, start: int,
          stop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry of the 64-bit counters ``start`` .. ``stop - 1`` under each
    key: two words of shape ``key.shape[:-1] + (stop - start,)``."""
    if key.device.type == "meta":
        words = key.new_empty(tuple(key.shape[:-1]) + (stop - start,))
        return words, words
    idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0, None], key[..., 1, None]
    return threefry2x32(k1, k2, idx >> 32, idx & _M32)


def _blocked(key: torch.Tensor, shape: tuple, fn,
             dtype: torch.dtype) -> torch.Tensor:
    """``fn(bits)`` of every element's 32 random bits (the counters of a
    draw of ``shape`` are its row-major iota), ``key.shape[:-1] + shape``
    of ``dtype``: in one piece up to :data:`BLOCK` elements over all keys,
    else in blocks of the counter range written into one preallocated
    output.  ``fn`` works element by element, so the blocks give the
    one-piece numbers bit for bit."""
    shape = tuple(shape)
    lead = tuple(key.shape[:-1])
    if key.device.type == "meta":
        return torch.empty(lead + shape, dtype=dtype, device="meta")
    n = math.prod(shape)
    per = max(1, BLOCK // max(1, math.prod(lead)))
    if n <= per:
        b1, b2 = _hash(key, 0, n)
        return fn(b1 ^ b2).reshape(lead + shape)
    out = torch.empty(lead + (n,), dtype=dtype, device=key.device)
    for start in range(0, n, per):
        stop = min(n, start + per)
        b1, b2 = _hash(key, start, stop)
        out[..., start:stop] = fn(b1 ^ b2)
        del b1, b2
    return out.reshape(lead + shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    b1, b2 = _hash(key, 0, num)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a scalar uint32 ``data``."""
    if key.device.type == "meta":
        return key.new_empty(key.shape)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & _M32)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element, ``key.shape[:-1] + shape`` (int64)."""
    return _blocked(key, shape, lambda bits: bits, torch.int64)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as XLA contracts it: the f32 product
    is exact in float64, so one float64 add and one cast to float32 round
    like a fused multiply-add (double rounding needs a tie at 2**-29)."""
    return (a.double() * b.double() + c.double()).float()


def _uniform_of(bits: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def uniform(key: torch.Tensor, shape: tuple, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """f32 ``U[minval, maxval)``: 23 mantissa bits under exponent 0, minus
    one, then ``floats * (maxval - minval) + minval`` as one fused
    multiply-add, as ``jax.random.uniform`` computes it under XLA."""
    lo, hi = _f32(minval, key.device), _f32(maxval, key.device)
    return _blocked(key, shape, lambda bits: _uniform_of(bits, lo, hi),
                    torch.float32)


def bernoulli(key: torch.Tensor, p, shape: tuple) -> torch.Tensor:
    """bool ``jax.random.bernoulli``: ``uniform(key, shape) < p``, the
    compare in float32."""
    return uniform(key, shape) < _f32(p, key.device)


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w = -log1p(-x^2), one set for w < 5 and one above.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv with XLA's polynomial and fused multiply-adds, so the
    port's normals sit within an ulp or two of ``jax.random.normal``
    (``torch.erfinv`` is a different approximation, ~6e-6 apart)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, _f32(a, x.device), _f32(b, x.device))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = fma(p, ww, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: tuple, divisor: float = 1.0
           ) -> torch.Tensor:
    """f32 standard normal: ``sqrt(2) * erfinv(U(nextafter(-1, 0), 1))``.

    ``divisor`` gives ``normal / divisor`` as jitted XLA computes it: the
    two constants fold into one, ``erfinv(u) * f32(f32(sqrt 2) /
    divisor)``."""
    dev = key.device
    lo = _f32(float(np.nextafter(np.float32(-1.0), np.float32(0.0))), dev)
    one = _f32(1.0, dev)
    c = _f32(np.float32(np.sqrt(2.0)) / np.float32(divisor), dev)
    return _blocked(key, shape,
                    lambda bits: c * _erfinv(_uniform_of(bits, lo, one)),
                    torch.float32)


def exponential(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """f32 ``Exp(1)``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(key, shape))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for uint32 values held in int64 lanes, without
    overflowing int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint``: two 32-bit draws combined by jax's
    multiply-mod (biased when the span is not a power of two, as in jax)."""
    if not (-2**31 <= minval < 2**31 and -2**31 <= maxval < 2**31):
        raise ValueError("randint bounds must lie in the int32 range")
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    mult = (2**16) % span
    mult = ((mult * mult) & _M32) % span          # uint32 wrap, as in jax
    off = (_mul32(higher % span, torch.full_like(higher, mult))
           + lower % span) & _M32
    off = off % span
    out = (minval + off) & _M32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _shuffle_rounds(n: int) -> int:
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, x) -> torch.Tensor:
    """``jax.random.permutation`` of ``arange(x)`` (int) or of the last axis
    of a 1-D-per-key tensor ``x``: jax's ``_shuffle``, i.e. stable sorts on
    fresh 32-bit keys, ``ceil(3 ln n / ln(2**32 - 1))`` rounds."""
    lead = key.shape[:-1]
    if isinstance(x, int):
        x = torch.arange(x, dtype=torch.int32, device=key.device)
    n = x.shape[-1]
    x = x.expand(lead + (n,))
    for _ in range(_shuffle_rounds(n)):
        keys = split(key, 2)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def gumbel(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """f32 standard Gumbel in ``jax.random.gumbel``'s default ``"low"``
    mode: ``-log(-log(U[tiny, 1)))``."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                shape: tuple) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` with
    replacement over the last axis: the argmax of Gumbel noise plus the
    logits (the lowest index wins a tie, as ``jnp.argmax``).  ``shape``
    ends with ``logits.shape[:-1]``; its prefix is the number of draws.
    Batched keys ``[..., 2]`` draw independently for their leading axes,
    which then lead ``logits`` too, as under ``vmap``."""
    lead = key.shape[:-1]
    batch = tuple(logits.shape[len(lead):-1])
    if tuple(shape[len(shape) - len(batch):]) != batch:
        raise ValueError(f"shape {shape} must end with the logits' batch "
                         f"shape {batch}")
    prefix = tuple(shape[:len(shape) - len(batch)])
    g = gumbel(key, prefix + batch + (logits.shape[-1],))
    lg = logits.reshape(lead + (1,) * len(prefix)
                        + tuple(logits.shape[len(lead):]))
    return torch.argmax(g + lg, dim=-1).to(torch.int32)


def _gamma_flat(keys: torch.Tensor, alpha: torch.Tensor,
                log_space: bool) -> torch.Tensor:
    """Gamma(alpha) (or its log) for each key ``[K, 2]`` and f32 ``alpha``
    [K]: jax's ``_gamma_one(key, alpha, log_space)``, element by element.

    Marsaglia and Tsang's rejection method; alpha < 1 is boosted to
    alpha + 1 and corrected by ``U^(1 / alpha)`` (``-Exp(1) / alpha`` in
    log space).  The two nested rejection loops run as masked loops over
    every element at once: an element that is done keeps its state, so
    each one consumes its own key stream exactly as the scalar loops
    do."""
    dev = keys.device
    one = torch.ones_like(alpha)
    boost = alpha >= one
    a = torch.where(boost, alpha, alpha + one)
    third = _f32(1.0 / 3.0, dev)
    d = a - third
    c = third / torch.sqrt(d)
    ks = split(keys)
    key, subkey = ks[:, 0], ks[:, 1]

    def rejected(x2, v, u):              # jax's loop condition
        squeeze = u >= one - _f32(0.0331, dev) * (x2 * x2)
        return squeeze & (torch.log(u) >= x2 * 0.5
                          + d * ((one - v) + torch.log(v)))

    x2 = torch.zeros_like(alpha)
    v3 = torch.ones_like(alpha)
    todo = rejected(x2, v3, torch.full_like(alpha, 2.0))   # all True
    while bool(todo.any()):
        ks = split(key, 3)
        key = torch.where(todo[:, None], ks[:, 0], key)
        x_key, u_key = ks[:, 1], ks[:, 2]
        x = torch.zeros_like(alpha)
        v = -one
        inner = todo.clone()
        while bool(inner.any()):
            kk = split(x_key)
            x_key = torch.where(inner[:, None], kk[:, 0], x_key)
            xn = normal(kk[:, 1], ())
            x = torch.where(inner, xn, x)
            v = torch.where(inner, fma(xn, c, one), v)
            inner = inner & (v <= 0.0)
        x2 = torch.where(todo, x * x, x2)
        v3 = torch.where(todo, v * v * v, v3)
        todo = todo & rejected(x2, v3, uniform(u_key, ()))
    if log_space:
        log_samples = -exponential(subkey, ())
        log_boost = torch.where(boost | (log_samples == 0.0),
                                torch.zeros_like(alpha),
                                log_samples * (one / alpha))
        return (torch.log(d) + torch.log(v3)) + log_boost
    samples = one - uniform(subkey, ())
    return (d * v3) * torch.where(boost, one,
                                  torch.pow(samples, one / alpha))


def _gamma(key: torch.Tensor, alpha, shape: tuple,
           log_space: bool) -> torch.Tensor:
    shape = tuple(shape)
    a = torch.broadcast_to(_f32(alpha, key.device), shape).reshape(-1)
    keys = split(key, math.prod(shape))
    return _gamma_flat(keys, a, log_space).reshape(shape)


def gamma(key: torch.Tensor, alpha, shape: tuple) -> torch.Tensor:
    """f32 ``jax.random.gamma(key, alpha, shape)`` for one key [2]:
    element i of the row-major flattening draws with key i of
    ``split(key, prod(shape))``."""
    return _gamma(key, alpha, shape, log_space=False)


def loggamma(key: torch.Tensor, alpha, shape: tuple) -> torch.Tensor:
    """f32 ``jax.random.loggamma(key, alpha, shape)``: log Gamma draws
    with :func:`gamma`'s key layout, precise for small alpha."""
    return _gamma(key, alpha, shape, log_space=True)


def dirichlet(key: torch.Tensor, alpha: torch.Tensor,
              shape: tuple) -> torch.Tensor:
    """f32 ``jax.random.dirichlet(key, alpha, shape)``: the softmax over
    the last axis of log-gamma draws of shape ``shape + alpha.shape[-1:]``,
    as jax computes it (max-shifted ``exp``, then a divide by the sum)."""
    lg = loggamma(key, alpha, tuple(shape) + (alpha.shape[-1],))
    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)
