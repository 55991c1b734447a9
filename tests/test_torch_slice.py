"""The whole slice: repro_torch's FL round engine against a live run of the
JAX engine, plus the port's package rules.

A second run uses the host greedy ``dagsa`` (both packages' default
scheduler) against JAX's eager path (``mode="eager"``, the only mode that
runs it), with the same config and gates; ``min_part_rate`` is compared
as float32, the precision the step path and the port record it in.

The run is the ``engine_sync`` config of test_golden_trajectories.py (12
users, 4 BSs, 120/40 samples, 1 local epoch, batch 10, seed 7, dagsa_jit,
3 rounds; JAX in ``mode="step"``).  Decisions (``n_selected``,
``min_part_rate``) must match exactly; ``t_round`` and ``wall_clock`` within
rtol=1e-5; the final global parameters within rtol=1e-4, atol=1e-5.
``test_acc`` may differ by one of the 40 test samples: a sample whose two
top logits tie within float32 rounding can take either class.
:func:`check_run_against_live_jax` holds any config of that world so, the
fault layer's and the async engine's records too; the other
``tests/test_torch_*.py`` files use it for their golden cases.
"""
import argparse
import ast
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.fl.rounds import FLConfig as JConfig  # noqa: E402
from repro.fl.rounds import FLSimulation as JSimulation  # noqa: E402
from repro.launch import fl_sim as j_fl_sim  # noqa: E402
from repro_torch.core import mobility  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation  # noqa: E402
from repro_torch.interop import params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import fl_sim, serve_decode  # noqa: E402
from repro_torch.models.api import init_cache  # noqa: E402



def cap_torch_threads() -> None:
    """Under pytest-xdist, cap this worker's torch to its share of the
    cores (cores // workers, at least one thread): each worker's default
    pool of one thread a core would contend with the others' on the same
    cores.  Outside xdist, torch keeps its default.  The port's test files
    call this at import; it changes no case, check or tolerance."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


cap_torch_threads()

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
ENGINE_SYNC = dict(n_train=120, n_test=40, local_epochs=1, batch_size=10,
                   eval_every=1, seed=7)


def test_engine_sync_slice_matches_live_jax_run():
    _check_slice_against_live_jax("dagsa_jit", "step")


def test_engine_sync_slice_with_host_dagsa_matches_live_jax_eager_run():
    check_run_against_live_jax(dict(scheduler="dagsa"), mode="eager",
                               port=_host_dagsa_run())


def _check_slice_against_live_jax(scheduler, mode):
    check_run_against_live_jax(dict(scheduler=scheduler), mode=mode)


@functools.cache
def _host_dagsa_run():
    """The port's 3-round ``engine_sync`` run under the default host
    greedy, (sim, records): built once, read by the host-greedy slice test
    and the resume test."""
    sim = FLSimulation(FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4),
                                **ENGINE_SYNC), device="cpu")
    return sim, sim.run(3)


def _same(got, want) -> bool:
    return got == want or (got != got and want != want)      # NaN == NaN


def check_run_against_live_jax(extra: dict, mode=None, rounds: int = 3,
                               layers=None, params_check=None,
                               jax_extra: dict | None = None,
                               edges: bool = False, prefix: int | None = None,
                               port=None, port_mode=None):
    """The port's run of the ``engine_sync`` world with the FLConfig
    fields ``extra`` against a live JAX run of the same config (``mode``
    as JAX's ``run`` takes it).  Exact: ``n_selected``, ``n_delivered``,
    ``n_inflight``, ``n_dropped``, ``handover_rate`` and, as float32,
    ``min_part_rate``; within rtol=1e-5: ``t_round``, ``wall_clock``,
    ``delivered_rate`` and ``goodput_mbit_s``; parameters rtol=1e-4,
    atol=1e-5 (the layers named in ``layers``; None: all of them), or
    ``params_check(port_params, jax_params)`` where given; ``test_acc``
    within one of the 40 samples.  ``jax_extra`` overrides fields of
    JAX's config (a ``FaultSpec`` of its own package); ``edges`` holds
    the hierarchical edge models as the global ones.  ``prefix`` also
    holds every parameter, rtol=1e-4, atol=1e-5, after the first
    ``prefix`` rounds: both runs stop there and resume (a run resumes
    exactly where it stopped).  ``port``: the port's (sim, records) of
    this config, run already; ``port_mode`` the mode of the port's run
    (None: its default).  Returns the port's simulation and records."""
    segments = [rounds] if prefix is None else [prefix, rounds - prefix]
    with jax.threefry_partitionable(True):
        jsim = JSimulation(JConfig(wireless=JWireless(n_users=12, n_bs=4),
                                   **ENGINE_SYNC,
                                   **{**extra, **(jax_extra or {})}))
        want, j_prefix = [], None
        for n in segments:
            if want:
                j_prefix = jax.tree.map(np.asarray, jsim.params)
            want += jsim.run(n, mode=mode)
        j_trees = [jax.tree.map(np.asarray, jsim.params)]
        if edges:
            j_trees.append(jax.tree.map(np.asarray, jsim.edge_params))
    if port is not None:
        tsim, got = port
    else:
        tsim = FLSimulation(FLConfig(wireless=WirelessConfig(n_users=12,
                                                             n_bs=4),
                                     **ENGINE_SYNC, **extra), device="cpu")
        got, t_prefix = [], None
        for n in segments:
            if got:
                t_prefix = params_to_numpy(tsim.params)
            got += tsim.run(n, mode=port_mode)
    assert [r.round_idx for r in got] == list(range(1, rounds + 1))
    if prefix is not None:
        for k in j_prefix:
            for leaf in j_prefix[k]:
                np.testing.assert_allclose(
                    t_prefix[k][leaf], j_prefix[k][leaf], rtol=1e-4,
                    atol=1e-5, err_msg=f"round {prefix}: {k}.{leaf}")
    for g, w in zip(got, want):
        for field in ("n_selected", "n_delivered", "n_inflight",
                      "n_dropped", "handover_rate"):
            assert _same(getattr(g, field), getattr(w, field)), \
                (g.round_idx, field, getattr(g, field), getattr(w, field))
        # the eager path divides the integer count in float64 on the host,
        # the step path and the port in float32: equal as float32
        assert np.float32(g.min_part_rate) == np.float32(w.min_part_rate)
        for field in ("t_round", "wall_clock", "delivered_rate",
                      "goodput_mbit_s"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                       rtol=1e-5, err_msg=field)
        assert abs(g.test_acc - w.test_acc) <= 1.0 / 40 + 1e-7
    t_trees = [params_to_numpy(tsim.params)]
    if edges:
        t_trees.append(params_to_numpy(tsim.edge_params))
    for t_params, j_params in zip(t_trees, j_trees):
        if params_check is not None:
            params_check(t_params, j_params)
            continue
        for k in (j_params if layers is None else layers):
            for leaf in j_params[k]:
                np.testing.assert_allclose(
                    t_params[k][leaf], j_params[k][leaf], rtol=1e-4,
                    atol=1e-5, err_msg=f"{k}.{leaf}")
    return tsim, got


def _parser_default(main, argv, dest, monkeypatch):
    """The default of ``dest`` in the parser that ``main`` builds, read as
    it parses and before it runs anything."""
    seen = {}

    class Parsed(Exception):
        pass

    def parse_args(self, args=None, namespace=None):
        seen["default"] = self.get_default(dest)
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(sys, "argv", ["fl_sim"])
    with pytest.raises(Parsed):
        main(*argv)
    return seen["default"]


def test_default_scheduler_is_the_references(monkeypatch):
    """Both packages schedule with the host greedy unless told otherwise:
    FLConfig() and the fl_sim CLIs."""
    assert FLConfig().scheduler == JConfig().scheduler == "dagsa"
    port = _parser_default(fl_sim.main, ([],), "scheduler", monkeypatch)
    ref = _parser_default(j_fl_sim.main, (), "scheduler", monkeypatch)
    assert port == ref == "dagsa"


def test_run_resumes_where_it_stopped():
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), **ENGINE_SYNC)
    whole = _host_dagsa_run()[1]
    sim = FLSimulation(cfg, device="cpu")
    parts = sim.run(1) + sim.run(2)
    assert sim.run(0) == []
    for a, b in zip(whole, parts):
        # exact equality, NaN equal to NaN (handover_rate on single tier)
        np.testing.assert_equal(dataclasses.asdict(a), dataclasses.asdict(b))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(PKG.parent)} imports {mod}"


def test_importing_the_engine_loads_no_jax():
    code = ("import sys; import repro_torch.fl.rounds, "
            "repro_torch.launch.fl_sim, repro_torch.models.lm, "
            "repro_torch.launch.serve_decode; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), **ENGINE_SYNC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLSimulation(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fl_sim.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_decode.main(["--reduced", "--batch", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(get_config("zamba2_1_2b").reduced(), 1, 4)


def test_config_rejects_what_the_port_lacks():
    # the stateful policies are ported: the config takes them, and so
    # does the buffered-async engine (their state rides the round step)
    from repro_torch.fl.rounds import ASYNC_SCHEDULERS
    for name in ("ucb", "biased-adaptive", "rr", "pf"):
        assert FLConfig(scheduler=name).scheduler == name
        assert name in ASYNC_SCHEDULERS
    with pytest.raises(ValueError, match="unknown scheduler"):
        FLConfig(scheduler="nope")
    with pytest.raises(ValueError, match="bs_layout"):
        FLConfig(bs_layout="hex")
    # every mobility model of the JAX registry is ported; a name outside
    # it raises
    with pytest.raises(ValueError, match="unknown mobility model"):
        mobility.step_named("levy-flight", torch.tensor([0, 1]),
                            torch.zeros((3, 2)), {}, WirelessConfig())


def test_static_mobility_keeps_users_in_place():
    pos = torch.rand((5, 2)) * 1000
    new, _ = mobility.step_named("static", torch.tensor([0, 1]), pos, {},
                                 WirelessConfig())
    assert torch.equal(new, pos)


def test_cli_runs_on_cpu(capsys):
    fl_sim.main(["--device", "cpu", "--rounds", "2", "--n-train", "200",
                 "--n-test", "40", "--batch-size", "4", "--local-epochs",
                 "1", "--bs-layout", "uniform"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:2] == ["round", "t_round"]
    assert [ln.split()[0] for ln in lines[1:3]] == ["1", "2"]
    assert lines[3] == "" and lines[4].startswith("acc@")
    assert len(lines) == 5
