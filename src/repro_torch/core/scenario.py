"""Declarative wireless-FL scenarios: ``ScenarioSpec`` and the named
registry (PyTorch port of ``repro.core.scenario``).

A :class:`ScenarioSpec` captures one world declaratively (mobility, BS
layout, bandwidth draw, shadowing, aggregation, device spreads,
partition, compression, fault model); ``SCENARIOS`` names the built-ins,
registered on import in the JAX package's order, and
:mod:`repro_torch.fl.faults` registers its three faulty worlds here.

    from repro_torch.core.scenario import get_scenario
    cfg = get_scenario("high-mobility").wireless()   # overrides baked in
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.core.mobility import MOBILITY_MODELS
from repro_torch.core.types import WirelessConfig

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

    def wireless(self, base: WirelessConfig | None = None) -> WirelessConfig:
        """Base WirelessConfig with this scenario's static overrides baked."""
        base = base or WirelessConfig()
        over: dict = {"speed_mps": self.speed_mps}
        if self.n_bs is not None:
            over["n_bs"] = self.n_bs
        if self.tcomp_min_s is not None:
            over["tcomp_min_s"] = self.tcomp_min_s
        if self.tcomp_max_s is not None:
            over["tcomp_max_s"] = self.tcomp_max_s
        return dataclasses.replace(base, **over)

    def sample_bs_bw(self, key: torch.Tensor,
                     cfg: WirelessConfig) -> torch.Tensor:
        """[M] per-BS bandwidth budget; a uniform draw iff heterogeneous."""
        if self.bw_min_mhz is None:
            return torch.full((cfg.n_bs,), cfg.bs_bandwidth_mhz,
                              device=key.device)
        return rng.uniform(key, (cfg.n_bs,), self.bw_min_mhz,
                           self.bw_max_mhz)


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


# Global sync period when hierarchical aggregation names no tau.
DEFAULT_TAU_GLOBAL = 5


# -- resolution: explicit settings beat the scenario, which beats the
# defaults.  One FL run (FLSimulation) and each scenario of a sweep resolve
# alike; ``strict`` (one run) also refuses what the run would ignore but a
# sweep applies only where it fits: a tau_global in a single-tier world,
# and the scenario's own Dirichlet alpha under an explicit non-Dirichlet
# partition, as the JAX package does.  ``spec`` None: no scenario.
def _whose(spec: ScenarioSpec | None) -> str:
    return f"scenario {spec.name!r}" if spec is not None else "the run"


def resolve_aggregation(spec: ScenarioSpec | None, aggregation: str | None,
                        tau_global: int | None, strict: bool = False
                        ) -> tuple[str, int]:
    """Effective (aggregation, tau)."""
    agg = aggregation or (spec.aggregation if spec else "single")
    if agg != "hierarchical":
        if strict and tau_global is not None:
            raise ValueError(
                f"tau_global={tau_global} only applies to "
                f"aggregation='hierarchical' (resolved aggregation is "
                f"{agg!r}); it would silently do nothing")
        return agg, 1
    if tau_global is not None:
        return agg, tau_global
    if spec is not None and spec.aggregation == "hierarchical":
        return agg, spec.tau_global
    return agg, DEFAULT_TAU_GLOBAL


def resolve_compress(spec: ScenarioSpec | None, compress: str | None,
                     topk_frac: float | None) -> tuple[str | None, float]:
    """Effective (compress, topk_frac); a topk_frac without a resolved
    mode raises."""
    comp = compress if compress is not None else (
        spec.compress if spec else None)
    if topk_frac is not None:
        if comp is None:
            raise ValueError(
                f"topk_frac={topk_frac} only applies with a compress mode; "
                f"{_whose(spec)} resolves to compression off — it would "
                f"silently do nothing")
        return comp, float(topk_frac)
    return comp, (float(spec.topk_frac) if spec is not None
                  and comp is not None else 1.0)


def resolve_partition(spec: ScenarioSpec | None, partition: str | None,
                      dirichlet_alpha: float | None, strict: bool = False
                      ) -> tuple[str, float | None]:
    """Effective (partition, alpha): alpha only for 'dirichlet'."""
    part = partition or (spec.partition if spec else "shard")
    alpha = (float(dirichlet_alpha) if dirichlet_alpha is not None
             else (spec.dirichlet_alpha if spec else None))
    if part == "dirichlet":
        if alpha is None:
            raise ValueError(
                f"partition='dirichlet' needs dirichlet_alpha > 0 "
                f"({_whose(spec)} sets none)")
        return part, alpha
    stray = alpha if strict else dirichlet_alpha
    if stray is not None:
        raise ValueError(
            f"dirichlet_alpha={stray} only applies with "
            f"partition='dirichlet' ({_whose(spec)} resolves to {part!r}); "
            f"it would silently do nothing")
    return part, None


# Built-ins, as the JAX package registers them.  ``figure`` names the
# paper plot whose regime the scenario probes.
_BUILTINS = (
    ScenarioSpec(
        name="paper-default", figure="Fig. 2",
        description="RD mobility at 20 m/s, grid BSs, homogeneous 1 MHz "
                    "bandwidth — the paper's baseline world."),
    ScenarioSpec(
        name="static", figure="Fig. 4 (v=0)", mobility="static",
        speed_mps=0.0, bs_layout="uniform",
        description="No mobility: users can be stuck with bad geometry "
                    "forever, the fairness-forced tail regime."),
    ScenarioSpec(
        name="high-mobility", figure="Fig. 4 (v=100)", speed_mps=100.0,
        description="RD at 100 m/s: channel decorrelates every round, "
                    "mobility acts as user diversity."),
    ScenarioSpec(
        name="hetero-bw", figure="Fig. 3", bw_min_mhz=0.5, bw_max_mhz=1.5,
        description="Heterogeneous per-BS bandwidth B_k ~ U[0.5, 1.5] MHz."),
    ScenarioSpec(
        name="shadowed", figure="Fig. 4 mechanism", shadowing=True,
        description="Spatially-correlated log-normal shadowing (8 dB): "
                    "static users keep their shadowing draw, movers "
                    "resample it."),
    ScenarioSpec(
        name="dense-bs", n_bs=16,
        description="2x the paper's BS density: shorter links, scheduling "
                    "pressure shifts from SNR to bandwidth."),
    ScenarioSpec(
        name="sparse-bs", n_bs=3, bs_layout="uniform",
        description="Sparse coverage: long links dominate, the latency "
                    "tail is geometry-bound."),
    ScenarioSpec(
        name="mega-fleet", n_bs=100, bs_layout="uniform",
        description="Million-user regime: 100 uniformly-dropped BSs; pair "
                    "with --n-users and --channel-dtype so the [N, M] "
                    "channel plane is stored compactly."),
    ScenarioSpec(
        name="waypoint", mobility="waypoint", pause_s=2.0,
        description="Random Waypoint with 2 s pauses: bursty mobility with "
                    "center-biased stationary density."),
    # Hierarchical (edge-aggregating) worlds, arXiv 2108.09103's regime.
    ScenarioSpec(
        name="hfl-default", aggregation="hierarchical", tau_global=5,
        description="Hierarchical FL in the paper's baseline world: per-BS "
                    "edge Eq. (2) every round, global sync every 5 rounds."),
    ScenarioSpec(
        name="hfl-high-mobility", aggregation="hierarchical", tau_global=5,
        speed_mps=100.0,
        description="Hierarchical FL at 100 m/s: frequent handovers make "
                    "users cross diverged edge models mid-interval — the "
                    "cluster-HFL paper's dominant convergence effect."),
    ScenarioSpec(
        name="hfl-sparse-bs", aggregation="hierarchical", tau_global=5,
        n_bs=3, bs_layout="uniform",
        description="Hierarchical FL under sparse coverage: few large "
                    "cells, rare handovers, strongly non-IID edge models."),
    # Heterogeneous-device and compressed-uplink worlds.
    ScenarioSpec(
        name="hetero-compute", figure="device heterogeneity",
        compute_spread=4.0, power_spread_db=6.0,
        description="ShuffleFL-style device spread: compute latency spans "
                    "1-4x and transmit power a 6 dB deficit across the "
                    "fleet, both fixed per user — stragglers are devices, "
                    "not draws."),
    ScenarioSpec(
        name="non-iid-pathological", figure="data heterogeneity",
        partition="dirichlet", dirichlet_alpha=0.1,
        description="Dirichlet(0.1) per-user class mixtures: most users "
                    "hold 1-2 classes, the pathological non-IID regime "
                    "where selection fairness (Eq. 8g) matters most."),
    ScenarioSpec(
        name="compressed-uplink", figure="Eq. (1) payload",
        compress="topk-int8", topk_frac=0.1,
        description="Top-10% magnitude sparsification + int8 stochastic "
                    "rounding on every uplink: ~8x smaller s_k in Eq. (1), "
                    "so bandwidth allocation and scheduling see a much "
                    "cheaper fleet."),
)
for _spec in _BUILTINS:
    register_scenario(_spec)
del _spec
