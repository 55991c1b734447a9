"""Fault injection and failure-aware round semantics (PyTorch port of
``repro.fl.faults``; the taxonomy and its reasoning are documented there).

Per user and round, all independent:

  * **uplink outage**, mobility-coupled: ``p = base + edge * (d_serv /
    r_cell) + handover`` clipped to [0, 1], with ``d_serv`` the distance to
    the camped (nearest) BS, ``r_cell = area / (2 sqrt(M))`` and the
    handover term on users whose camped BS changed this round;
  * **straggler**: the compute time times ``exp(sigma * N(0, 1))``;
  * **crash**: the update never arrives (Bernoulli);
  * **corrupted update**: NaN, Inf, or the update scaled by a large
    factor; the server's finite screen and ``clip_norm`` defend.

The server stops waiting at ``deadline_s`` (deadline-truncated Eq. (3),
:mod:`repro_torch.core.latency`).  :func:`delivery_probability` is the
pre-scheduling estimate that ``dagsa-r`` discounts the SNR by.  A
default :class:`FaultSpec` is inert (``active`` is False) and the round
engine then draws exactly the fault-free keys.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.core.scenario import ScenarioSpec, register_scenario
from repro_torch.core.types import WirelessConfig
from repro_torch.tree import tree_map

CORRUPT_MODES = ("nan", "inf", "scale")
_MODE_NAN, _MODE_INF, _MODE_SCALE = range(3)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative per-round fault model (plain hashable scalars).

    Probabilities are per user per round; ``deadline_s=inf`` disables the
    deadline and ``clip_norm=None`` the server's norm clip.
    """

    outage_base: float = 0.0       # distance-independent loss floor
    outage_edge: float = 0.0       # extra hazard at the nominal cell edge
    outage_handover: float = 0.0   # extra hazard on a camped-BS change
    straggler_sigma: float = 0.0   # tcomp *= exp(sigma * N(0,1))
    crash_prob: float = 0.0
    corrupt_prob: float = 0.0
    corrupt_mode: str = "nan"      # nan | inf | scale
    corrupt_scale: float = 1e3     # multiplier for mode="scale"
    deadline_s: float = math.inf   # T_dl: the server stops waiting here
    clip_norm: Optional[float] = None  # L2 clip of (update - reference)

    def __post_init__(self):
        for f in ("outage_base", "outage_edge", "outage_handover",
                  "crash_prob", "corrupt_prob"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.straggler_sigma < 0.0:
            raise ValueError("straggler_sigma must be >= 0")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}; "
                             f"choose from {CORRUPT_MODES}")
        if not self.deadline_s > 0.0:
            raise ValueError("deadline_s must be > 0 (inf disables)")
        if self.clip_norm is not None and not self.clip_norm > 0.0:
            raise ValueError("clip_norm must be > 0 (None disables)")

    @property
    def active(self) -> bool:
        """Whether this spec changes round semantics at all; an inert spec
        runs the exact fault-free round (the same PRNG splits)."""
        return (self.outage_base > 0.0 or self.outage_edge > 0.0
                or self.outage_handover > 0.0 or self.straggler_sigma > 0.0
                or self.crash_prob > 0.0 or self.corrupt_prob > 0.0
                or math.isfinite(self.deadline_s)
                or self.clip_norm is not None)

    def to_json(self) -> dict:
        """Strict-JSON-safe dict (an ``inf`` deadline -> None)."""
        d = dataclasses.asdict(self)
        if not math.isfinite(d["deadline_s"]):
            d["deadline_s"] = None
        return d


NO_FAULTS = FaultSpec()

# Key order of fault_params.
FAULT_PARAM_KEYS = ("outage_base", "outage_edge", "outage_handover",
                    "straggler_sigma", "crash_prob", "corrupt_prob",
                    "corrupt_mode_id", "corrupt_scale", "deadline_s",
                    "clip_norm")


def fault_params(spec: FaultSpec) -> dict:
    """The spec as the flat scalar dict the samplers read
    (``clip_norm=None`` lowers to ``inf``)."""
    return {
        "outage_base": spec.outage_base,
        "outage_edge": spec.outage_edge,
        "outage_handover": spec.outage_handover,
        "straggler_sigma": spec.straggler_sigma,
        "crash_prob": spec.crash_prob,
        "corrupt_prob": spec.corrupt_prob,
        "corrupt_mode_id": CORRUPT_MODES.index(spec.corrupt_mode),
        "corrupt_scale": spec.corrupt_scale,
        "deadline_s": spec.deadline_s,
        "clip_norm": math.inf if spec.clip_norm is None else spec.clip_norm,
    }


def nominal_cell_radius(cfg: WirelessConfig) -> float:
    """Half the pitch of a sqrt(M) x sqrt(M) grid over the area (host
    float): the distance at which the edge hazard saturates."""
    return 0.5 * cfg.area_m / math.sqrt(cfg.n_bs)


def edge_proximity(dist: torch.Tensor, serving: torch.Tensor,
                   cfg: WirelessConfig) -> torch.Tensor:
    """[N] in [0, 1]: 0 at the camped BS, 1 at or beyond the nominal
    cell radius."""
    d_serv = torch.gather(dist, 1, serving.long()[:, None])[:, 0]
    return torch.clamp(d_serv / nominal_cell_radius(cfg), 0.0, 1.0)


def outage_probability(fp: dict, edge_frac: torch.Tensor,
                       handover: torch.Tensor) -> torch.Tensor:
    """[N] per-user uplink outage probability this round."""
    p = (fp["outage_base"] + fp["outage_edge"] * edge_frac
         + fp["outage_handover"] * handover.float())
    return torch.clamp(p, 0.0, 1.0)


def delivery_probability(fp: dict, edge_frac: torch.Tensor,
                         handover: torch.Tensor) -> torch.Tensor:
    """[N] estimated P(update delivered) from what the server observes
    before scheduling: the outage hazard and the crash rate (stragglers
    and the deadline depend on the bandwidth split, not decided yet)."""
    return ((1.0 - outage_probability(fp, edge_frac, handover))
            * (1.0 - fp["crash_prob"]))


def sample_round_faults(key: torch.Tensor, fp: dict,
                        edge_frac: torch.Tensor, handover: torch.Tensor,
                        tcomp: torch.Tensor):
    """One round's faults: ``(tcomp_eff, alive, corrupt)``, the compute
    times with the log-normal straggler factor, [N] bool uplink survived
    (no outage, no crash) and [N] bool update poisoned.  ``key`` splits
    into 4 for one normal and three uniform draws, in that order."""
    k_strag, k_out, k_crash, k_corr = rng.split(key, 4).unbind(0)
    shape = tuple(tcomp.shape)
    mult = torch.exp(fp["straggler_sigma"] * rng.normal(k_strag, shape))
    tcomp_eff = tcomp * mult
    p_out = outage_probability(fp, edge_frac, handover)
    outage = rng.uniform(k_out, shape) < p_out
    crash = rng.bernoulli(k_crash, fp["crash_prob"], shape)
    corrupt = rng.bernoulli(k_corr, fp["corrupt_prob"], shape)
    return tcomp_eff, ~(outage | crash), corrupt


def corrupt_updates(client_params, corrupt: torch.Tensor, mode_id: int,
                    scale: float):
    """Poison the flagged clients' parameter trees ([N, ...] leaves): NaN
    or Inf overwrite the update, "scale" multiplies it (finite, caught
    only by ``clip_norm``)."""
    def leaf(c):
        flag = corrupt.reshape((-1,) + (1,) * (c.dim() - 1))
        if mode_id == _MODE_SCALE:
            poisoned = (c.float() * scale).to(c.dtype)
        else:
            bad = math.inf if mode_id == _MODE_INF else math.nan
            poisoned = torch.full((), bad, dtype=c.dtype, device=c.device)
        return torch.where(flag, poisoned, c)

    return tree_map(leaf, client_params)


FAULT_PRESETS: dict[str, FaultSpec] = {
    "none": NO_FAULTS,
    "faulty-uplink": FaultSpec(outage_base=0.05, outage_edge=0.5,
                               outage_handover=0.4),
    "straggler-heavy": FaultSpec(straggler_sigma=0.8, crash_prob=0.05,
                                 deadline_s=1.5),
    "adversarial-updates": FaultSpec(corrupt_prob=0.15, corrupt_mode="nan",
                                     clip_norm=25.0),
}


def get_faults(name: str) -> FaultSpec:
    try:
        return FAULT_PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown fault preset {name!r}; choose from "
                         f"{tuple(FAULT_PRESETS)}") from None


# The paper-default world with one fault preset switched on each.
_FAULT_SCENARIOS = (
    ScenarioSpec(
        name="faulty-uplink",
        description="Paper-default world with mobility-coupled uplink "
                    "outage: 5% floor, +50% hazard at the cell edge, +40% "
                    "on handover.  The dagsa-r regime.",
        speed_mps=50.0, faults=FAULT_PRESETS["faulty-uplink"]),
    ScenarioSpec(
        name="straggler-heavy",
        description="Log-normal compute stragglers (sigma=0.8) + 5% "
                    "crashes under a 1.5 s round deadline: late updates "
                    "are dropped, not waited for.",
        faults=FAULT_PRESETS["straggler-heavy"]),
    ScenarioSpec(
        name="adversarial-updates",
        description="15% of delivered updates poisoned with NaNs; the "
                    "server's finite-screening + norm-clip defenses keep "
                    "the global model finite.",
        faults=FAULT_PRESETS["adversarial-updates"]),
)
for _spec in _FAULT_SCENARIOS:
    register_scenario(_spec)
del _spec
