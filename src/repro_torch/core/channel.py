"""Wireless channel: 3GPP-style path loss + Rayleigh fading (PyTorch port
of ``repro.core.channel``).

Paper Eq. (4): uplink rate ``r = B log2(1 + p |h|^2 / N0)`` with
``PL(dB) = 128.1 + 37.6 log10(D_km)``.  Powers are spectral densities, so
the SNR does not depend on the allocated bandwidth.  On top of the paper's
model: a spatially correlated log-normal shadowing field
(:func:`sample_shadowing`), per-user device hooks in :func:`make_problem`
(compute-time stretch, transmit-power deficit, uplink payload), and the
compact channel planes of the fleet-scale sweeps (``bf16``, or ``int8``
dB codes with a per-BS scale; :func:`encode_channel`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import const, rng
from repro_torch.core.types import (MobilityState, SchedulingProblem,
                                    WirelessConfig)

# Storage types of the per-round [N, M] channel plane.
CHANNEL_DTYPES = ("f32", "bf16", "int8")

# Random Fourier features of the shadowing field, per BS.
_SHADOW_FEATURES = 64

# Constants as XLA folds them (float32): 1 / ln 2 for a division by
# log(2), 10 log10(e) for 10 log10(x), 0.1 for a division by 10.
_INV_LN2 = float(np.float32(1.0) / np.float32(math.log(2.0)))
_INV_LN2_BF16 = float(np.float32(1.0) / np.float32(
    torch.tensor(math.log(2.0), dtype=torch.bfloat16).item()))
_DB_PER_NEPER = float(np.float32(np.float32(math.log10(math.e)) * 10))
_TENTH = float(np.float32(0.1))


def path_loss_db(dist_m: torch.Tensor) -> torch.Tensor:
    """128.1 + 37.6 log10(D) with D in km (paper §II-C)."""
    return 128.1 + 37.6 * torch.log10(torch.clamp(dist_m, min=1.0) / 1000.0)


def mean_snr(dist_m: torch.Tensor, cfg: WirelessConfig) -> torch.Tensor:
    """Linear mean SNR (large-scale only): 10^((p - N0 - PL)/10)."""
    snr_db = cfg.tx_dbm_mhz - cfg.noise_dbm_mhz - path_loss_db(dist_m)
    return torch.pow(10.0, snr_db / 10.0)


def sample_snr(key: torch.Tensor, dist_m: torch.Tensor, cfg: WirelessConfig,
               shadow_db: torch.Tensor | None = None) -> torch.Tensor:
    """Rayleigh-faded linear SNR: |h|^2 ~ Exp(1) on top of the mean SNR,
    times ``10^(shadow_db / 10)`` when a shadowing field [N, M] (dB) is
    given."""
    gain = rng.exponential(key, tuple(dist_m.shape))
    snr = mean_snr(dist_m, cfg) * gain
    if shadow_db is not None:
        snr = snr * torch.pow(10.0, shadow_db / 10.0)
    return snr


def sample_shadowing(key: torch.Tensor, user_pos: torch.Tensor,
                     bs_pos: torch.Tensor, cfg: WirelessConfig,
                     sigma_db: float = 8.0,
                     corr_dist_m: float = 50.0) -> torch.Tensor:
    """Spatially correlated log-normal shadowing, [N, M] dB.

    One random field per BS, evaluated at each user's position through 64
    random Fourier features ``cos(w . x + phi)`` with ``w ~ N(0, I) /
    corr_dist_m``: a user who barely moves sees barely changing
    shadowing, and the same key gives the same field every round."""
    kw, kp = rng.split(key).unbind(0)
    m = bs_pos.shape[0]
    freqs = rng.normal(kw, (m, _SHADOW_FEATURES, 2), divisor=corr_dist_m)
    phases = rng.uniform(kp, (m, _SHADOW_FEATURES), 0.0, 2.0 * math.pi)
    # [N, M, F]: w . x + phi; XLA's two-term dot is one multiply-add,
    # x1 w1 + (x0 w0)
    x = user_pos[:, None, None, :]
    proj = rng.fma(x[..., 1], freqs[None, :, :, 1],
                   x[..., 0] * freqs[None, :, :, 0]) + phases[None]
    field = math.sqrt(2.0 / _SHADOW_FEATURES) * torch.cos(proj).sum(dim=-1)
    return sigma_db * field


def dist_and_shadow(pos: torch.Tensor, bs_pos: torch.Tensor, shadow_sigma,
                    k_shadow: torch.Tensor, cfg: WirelessConfig,
                    user_chunk: int | None = None):
    """[N, M] distances and ``shadow_sigma`` times the unit shadowing field,
    or None for the field when ``shadow_sigma`` is 0: the JAX package's
    zero field changes no SNR (``10^(0 / 10)`` is 1 exactly), so the port
    skips its [N, M, 64] features.

    ``user_chunk`` evaluates both in blocks of that many users, so the
    field's features peak at [user_chunk, M, 64]: every value is a user's
    own (the field's frequencies and phases come from ``k_shadow`` alone),
    so the blocks give the unchunked call's values bit for bit.  The last
    block is the remainder (the JAX package pads it to a whole block and
    drops the padding)."""
    def block(p):
        d = MobilityState(user_pos=p, bs_pos=bs_pos).distances()
        if not shadow_sigma > 0.0:
            return d, None
        return d, shadow_sigma * sample_shadowing(k_shadow, p, bs_pos, cfg,
                                                  sigma_db=1.0)

    n = pos.shape[0]
    if not user_chunk or user_chunk >= n:
        return block(pos)
    parts = [block(pos[i0:i0 + user_chunk]) for i0 in range(0, n, user_chunk)]
    d = torch.cat([q[0] for q in parts])
    sh = None if parts[0][1] is None else torch.cat([q[1] for q in parts])
    return d, sh


def spectral_efficiency(snr: torch.Tensor) -> torch.Tensor:
    """log2(1 + SNR), bits/s/Hz, as ``jnp.log2`` computes it: ``log``
    over ``log(2)`` in the input's type, which XLA turns into a multiply
    by the float32 reciprocal (of bfloat16 ``log(2)`` for a bfloat16
    input, every op rounded to bfloat16)."""
    x = 1.0 + snr
    if x.dtype == torch.bfloat16:
        return torch.log(x) * _INV_LN2_BF16
    return torch.log(x) * _INV_LN2


def bandwidth_time_coeff(snr: torch.Tensor, cfg: WirelessConfig,
                         payload_mbit: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """c_{i,k} = s_i / log2(1 + snr_{i,k})  [MHz * s].

    ``payload_mbit`` [N] is each user's uplink payload s_i (compressed
    uplink); ``None`` keeps the uniform ``cfg.model_mbit`` exactly.  A
    bfloat16 plane gives bfloat16 coefficients, every op rounded to
    bfloat16 as XLA rounds the JAX package's."""
    se = torch.clamp(spectral_efficiency(snr), min=1e-9)
    if payload_mbit is None:
        return cfg.model_mbit / se
    return payload_mbit.float()[:, None] / se


def compress_channel(x: torch.Tensor, channel_dtype: str) -> torch.Tensor:
    """A channel-plane array in its storage type (``"f32"`` as it is,
    ``"bf16"`` rounded to nearest even); ``"int8"`` needs the per-BS scale
    row of :func:`encode_channel`."""
    if channel_dtype == "f32":
        return x
    if channel_dtype == "bf16":
        return x.to(torch.bfloat16)
    if channel_dtype == "int8":
        raise ValueError("channel_dtype 'int8' carries a per-BS scale row; "
                         "encode with channel.encode_channel, not "
                         "compress_channel")
    raise ValueError(f"unknown channel_dtype {channel_dtype!r}; "
                     f"choose from {CHANNEL_DTYPES}")


def quantize_snr_int8(snr: torch.Tensor):
    """Per-BS symmetric int8 codes of linear SNR in dB:
    ``(q [N, M] int8, scale [M] f32)`` with ``10 log10(snr) ~ q * scale``.
    Codes order users within a BS (column); across BSs compare
    ``q * scale``.  ``round`` is half to even, as ``jnp.round``."""
    # 10 log10(x) as jitted XLA computes it: log(x) times one folded
    # constant (jnp.log10 multiplies by log10(e))
    db = torch.log(torch.clamp(snr.float(), min=1e-12)) * _DB_PER_NEPER
    scale = torch.clamp(db.abs().amax(dim=0), min=1e-6) / 127.0
    q = torch.clamp(torch.round(db / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_snr_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Linear SNR from int8 dB codes: ``10^(q * scale / 10)``."""
    db = q.float() * scale.float()[None, :]
    return torch.pow(10.0, db * _TENTH)       # XLA's x / 10


def encode_channel(snr: torch.Tensor, channel_dtype: str):
    """One round's linear SNR in its channel-plane storage:
    ``(snr_store, snr_scale, snr_linear)``.  ``snr_store`` is what the
    selection kernels read (the f32 / bf16 plane, or int8 dB codes),
    ``snr_scale`` the int8 plane's per-BS scale (else None), and
    ``snr_linear`` a linear SNR for everything that needs values (the
    stored plane for f32 / bf16, the dequantised plane for int8)."""
    if channel_dtype == "int8":
        q, scale = quantize_snr_int8(snr)
        return q, scale, dequantize_snr_int8(q, scale)
    s = compress_channel(snr, channel_dtype)
    return s, None, s


def plane_coefficients(snr_store: torch.Tensor, snr_linear: torch.Tensor,
                       channel_dtype: str, cfg: WirelessConfig,
                       payload_mbit: torch.Tensor | None = None):
    """The Eq. (11) coefficients of a sweep's channel plane, as the JAX
    package's jitted sweep computes them: ``(coeff, loop_coeff)``.

    f32: the plane's coefficients.  int8: those of the dequantised plane
    (the codes carry only ranks and dB values).  bf16: the spectral
    efficiency rounded to bfloat16 op by op; XLA keeps the last division
    in float32 for every solve outside the greedy's loop (``coeff``) and
    rounds it to bfloat16 only for the loop's candidate solves
    (``loop_coeff``; ROADMAP C.10).  ``loop_coeff`` is None where the two
    are one plane."""
    if channel_dtype == "int8":
        return bandwidth_time_coeff(snr_linear, cfg, payload_mbit), None
    if channel_dtype == "f32":
        return bandwidth_time_coeff(snr_store, cfg, payload_mbit), None
    se = torch.clamp(spectral_efficiency(snr_store), min=1e-9).float()
    num = (cfg.model_mbit if payload_mbit is None
           else payload_mbit.float()[:, None])
    coeff = num / se
    return coeff, compress_channel(coeff, channel_dtype)


def sample_tcomp(key: torch.Tensor, cfg: WirelessConfig,
                 scale: torch.Tensor | None = None) -> torch.Tensor:
    """Per-user local computation latency ~ U(tmin, tmax) (paper §IV),
    times a per-user compute multiplier ``scale`` [N] where given."""
    t = rng.uniform(key, (cfg.n_users,), cfg.tcomp_min_s, cfg.tcomp_max_s)
    return t if scale is None else t * scale


def make_problem(key: torch.Tensor, state: MobilityState, cfg: WirelessConfig,
                 part_counts: torch.Tensor, round_idx,
                 bs_bw: torch.Tensor | None = None,
                 shadow_db: torch.Tensor | None = None,
                 tcomp_scale: torch.Tensor | None = None,
                 power_scale: torch.Tensor | None = None,
                 payload_mbit: torch.Tensor | None = None
                 ) -> SchedulingProblem:
    """Assemble one round's SchedulingProblem from the physical state.

    ``necessary`` is Eq. (8g) against the post-round floor: user i must
    participate if sitting out would leave its count below
    ``rho1 * (round_idx + 1)`` (computed in float32, as the JAX engine
    does; ``round_idx`` an int or a 0-dim float32 device tensor, which a
    captured round reads at replay).  Hooks, each None for the paper's homogeneous world:
    ``shadow_db`` [N, M] a shadowing field (dB), ``tcomp_scale`` [N] a
    compute-time stretch, ``power_scale`` [N] a factor on each user's
    linear SNR (a transmit-power deficit), ``payload_mbit`` [N] each
    user's uplink payload in place of the uniform S."""
    k_snr, k_tc = rng.split(key)
    snr = sample_snr(k_snr, state.distances(), cfg, shadow_db=shadow_db)
    if power_scale is not None:
        snr = snr * power_scale[:, None]
    tcomp = sample_tcomp(k_tc, cfg, scale=tcomp_scale)
    coeff = bandwidth_time_coeff(snr, cfg, payload_mbit=payload_mbit)
    dev = part_counts.device
    if bs_bw is None:
        bs_bw = torch.full((cfg.n_bs,), cfg.bs_bandwidth_mhz, device=dev)
    floor = (const(cfg.rho1, torch.float32, dev)
             * const(round_idx + 1, torch.float32, dev))
    necessary = part_counts < floor
    return SchedulingProblem(
        snr=snr, tcomp=tcomp, bs_bw=bs_bw, coeff=coeff, necessary=necessary,
        min_participants=int(math.ceil(cfg.rho2 * cfg.n_users)),
        payload_mbit=payload_mbit)
