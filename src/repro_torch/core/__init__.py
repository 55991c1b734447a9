"""Paper contribution: mobility-aware joint user scheduling and bandwidth
allocation for low-latency federated learning (DAGSA and baselines);
PyTorch port of ``repro.core``, with the same public names.

The names load on first access, so importing a kernel module (which reads
``repro_torch.core.bandwidth``) does not import the scheduler registry.
"""
import importlib

_EXPORTS = {
    "MobilityState": "types", "ScheduleResult": "types",
    "SchedulingProblem": "types", "WirelessConfig": "types",
    "BATCH_SCHEDULERS": "scheduler", "SCHEDULERS": "scheduler",
    "ParticipationState": "scheduler", "schedule": "scheduler",
    "schedule_batch": "scheduler",
    "MOBILITY_MODELS": "mobility", "register_mobility_model": "mobility",
    "SCENARIOS": "scenario", "ScenarioSpec": "scenario",
    "get_scenario": "scenario", "register_scenario": "scenario",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)


def __dir__():
    return sorted(list(globals()) + __all__)
