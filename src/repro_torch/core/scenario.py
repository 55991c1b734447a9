"""Declarative wireless-FL scenarios: ``ScenarioSpec`` and the named
registry (PyTorch port of the registry core of ``repro.core.scenario``).

A :class:`ScenarioSpec` captures one world declaratively (mobility, BS
layout, bandwidth draw, shadowing, aggregation, device spreads,
partition, compression, fault model); ``SCENARIOS`` names them, and
:mod:`repro_torch.fl.faults` registers its three faulty worlds here.  The
JAX package's built-in worlds, ``ScenarioSpec.wireless`` /
``sample_bs_bw`` and ``FLConfig.scenario`` come with the world models
they need (ROADMAP A.5); until then the registry holds only what a
module of the port registers, and the validation accepts only the
mobility models the port has.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.mobility import MOBILITY_MODELS

BS_LAYOUTS = ("grid", "uniform")

# FL aggregation architectures a scenario can ask for: the paper's one
# tier, or per-BS edge aggregation with a global sync every tau_global
# rounds.
AGGREGATIONS = ("single", "hierarchical")

# Uplink update-compression modes: top-k magnitude sparsification,
# optionally + int8 stochastic rounding.  None is the full f32 payload.
COMPRESS_MODES = ("topk", "topk-int8")

# Non-IID data partitioners: the paper's label shards or a per-user
# Dirichlet(alpha) class mixture.
PARTITIONS = ("shard", "dirichlet")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One declarative mobility / channel world.

    ``None`` for an optional field means "inherit the base
    WirelessConfig".  ``bw_min_mhz`` / ``bw_max_mhz`` set together enable
    the Fig. 3 heterogeneous-bandwidth draw B_k ~ U[min, max].
    """

    name: str
    description: str = ""
    figure: str = ""                    # paper figure the scenario reproduces
    # -- mobility ----------------------------------------------------------
    mobility: str = "rd"                # key into MOBILITY_MODELS
    speed_mps: float = 20.0
    pause_s: float = 0.0                # waypoint pause time
    gm_memory: float = 0.75             # gauss_markov AR(1) coefficient
    # -- topology ----------------------------------------------------------
    bs_layout: str = "grid"             # grid | uniform
    n_bs: Optional[int] = None
    # -- bandwidth / compute heterogeneity ---------------------------------
    bw_min_mhz: Optional[float] = None  # both set -> B_k ~ U[min, max]
    bw_max_mhz: Optional[float] = None
    tcomp_min_s: Optional[float] = None
    tcomp_max_s: Optional[float] = None
    # -- fading ------------------------------------------------------------
    shadowing: bool = False
    shadow_sigma_db: float = 8.0
    # -- FL aggregation architecture ---------------------------------------
    aggregation: str = "single"         # single | hierarchical
    tau_global: int = 1                 # global sync period (hierarchical)
    # -- device heterogeneity: compute latency stretches by
    # compute_spread**u and uplink SNR scales by 10^(-power_spread_db u / 10)
    # for one fixed draw u ~ U[0, 1) a user; the defaults are no-ops ------
    compute_spread: float = 1.0
    power_spread_db: float = 0.0
    # -- data partition ----------------------------------------------------
    partition: str = "shard"            # shard | dirichlet
    dirichlet_alpha: Optional[float] = None   # REQUIRED iff dirichlet
    # -- uplink compression ------------------------------------------------
    compress: Optional[str] = None      # None | topk | topk-int8
    topk_frac: float = 1.0              # kept fraction per leaf (0, 1]
    # -- fault model: a repro_torch.fl.faults.FaultSpec or None (typed
    # loosely because fl.faults imports this module to register into it) --
    faults: Optional[object] = None

    def __post_init__(self):
        if self.faults is not None and not hasattr(self.faults, "active"):
            raise ValueError(
                "faults must be a repro_torch.fl.faults.FaultSpec (or "
                f"None), got {type(self.faults).__name__}")
        if self.mobility not in MOBILITY_MODELS:
            raise ValueError(f"unknown mobility model {self.mobility!r}; "
                             f"choose from {tuple(MOBILITY_MODELS)}")
        if self.bs_layout not in BS_LAYOUTS:
            raise ValueError(f"unknown bs_layout {self.bs_layout!r}; "
                             f"choose from {BS_LAYOUTS}")
        if (self.bw_min_mhz is None) != (self.bw_max_mhz is None):
            raise ValueError("set bw_min_mhz and bw_max_mhz together")
        if self.bw_min_mhz is not None and self.bw_max_mhz < self.bw_min_mhz:
            raise ValueError("bw_max_mhz must be >= bw_min_mhz")
        if not 0.0 <= self.gm_memory < 1.0:
            raise ValueError("gm_memory must be in [0, 1)")
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             f"choose from {AGGREGATIONS}")
        if self.tau_global < 1:
            raise ValueError("tau_global must be >= 1")
        if self.aggregation == "single" and self.tau_global != 1:
            raise ValueError("tau_global only applies to "
                             "aggregation='hierarchical'; it would silently "
                             "do nothing on a single-tier scenario")
        if self.compute_spread < 1.0:
            raise ValueError("compute_spread is the slowest/fastest device "
                             "ratio; it must be >= 1.0")
        if self.power_spread_db < 0.0:
            raise ValueError("power_spread_db must be >= 0 (a deficit)")
        if self.partition not in PARTITIONS:
            raise ValueError(f"unknown partition {self.partition!r}; "
                             f"choose from {PARTITIONS}")
        if self.partition == "dirichlet":
            if self.dirichlet_alpha is None or not self.dirichlet_alpha > 0:
                raise ValueError("partition='dirichlet' needs "
                                 "dirichlet_alpha > 0")
        elif self.dirichlet_alpha is not None:
            raise ValueError("dirichlet_alpha only applies to "
                             "partition='dirichlet'; it would silently do "
                             "nothing")
        if self.compress is not None and self.compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compress mode {self.compress!r}; "
                             f"choose from {COMPRESS_MODES}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError("topk_frac must be in (0, 1]")
        if self.compress is None and self.topk_frac != 1.0:
            raise ValueError("topk_frac only applies with a compress mode; "
                             "it would silently do nothing")
        if not (self.speed_mps >= 0.0 and self.pause_s >= 0.0):
            raise ValueError("speed_mps and pause_s must be >= 0")


SCENARIOS: dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec,
                      overwrite: bool = False) -> ScenarioSpec:
    """Add a spec to the registry."""
    if spec.name in SCENARIOS and not overwrite:
        raise ValueError(f"scenario {spec.name!r} already registered")
    SCENARIOS[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; choose from "
                         f"{tuple(SCENARIOS)}") from None
