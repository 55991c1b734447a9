"""The fused round engine: ``FLSimulation.run(mode=...)``, ``run_round()``
and ``fl_sim --mode`` (repro_torch.fl.fused, repro_torch.kernels.
graph_while) against the JAX package's execution modes.

At the ``engine_sync`` size (12 users, 4 BSs, seed 7, 3 rounds):
* the port's ``run(3, mode="fused")`` against a live JAX ``run(3,
  mode="fused")`` for ``dagsa_jit`` (``compute="full"`` and
  ``"selected"``), ``rs`` and ``ucb``, through
  ``check_run_against_live_jax``'s tolerances;
* the port's fused, step and eager runs against each other (decisions
  exact, records rtol 1e-6, parameters 1e-5: JAX's ``tests/test_fl.py``),
  and a fused run resumed across two calls;
* every mode refusal of JAX's ``run``, on JAX's own message;
* the fused step makes no host sync and no host-to-device copy (what a
  CUDA graph capture refuses), for every fused scheduler, the
  synchronous variants and the async tick (the tick index read from the
  device), and neither does a learning sweep bucket's step over two
  cells (sync, hierarchical, faulty async) nor a wireless bucket's step
  over five worlds x 2 seeds (f32, bf16, int8; user chunks);
* the wireless bucket step run with the Python round index frozen at 0
  and only the device index set, as a captured round replays, gives
  ``run_sweep``'s records;
* ``run(n, mode="async")`` equals n ``run_round()`` ticks;
* the greedy alone makes no host sync but its loop test (a WHILE node's
  test on the card) on the 80 problems of ``test_torch_dagsa.py``.

On the CPU the fused engine runs the same step without a graph; the
captured graph itself is held by ``tests/test_torch_cuda.py`` on the card.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from torch.utils._python_dispatch import (TorchDispatchMode,  # noqa: E402
                                          _disable_current_modes)

from repro.fl.rounds import FLConfig as JConfig  # noqa: E402
from repro.fl.rounds import FLSimulation as JSimulation  # noqa: E402
from repro.fl.rounds import FUSED_SCHEDULERS as J_FUSED  # noqa: E402
from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.launch import fl_sim as j_fl_sim  # noqa: E402
from repro_torch.core import dagsa_jit  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl import rounds as t_rounds  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation  # noqa: E402
from repro_torch.kernels import _lib, graph_while  # noqa: E402
from repro_torch.launch import fl_sim  # noqa: E402
from tests.test_torch_dagsa import _problem  # noqa: E402
from tests.test_torch_slice import (ENGINE_SYNC, _parser_default,  # noqa: E402
                                    cap_torch_threads,
                                    check_run_against_live_jax)

cap_torch_threads()

W = dict(n_users=12, n_bs=4)


def _sim(**extra) -> FLSimulation:
    return FLSimulation(FLConfig(wireless=WirelessConfig(**W), **ENGINE_SYNC,
                                 **extra), device="cpu")


def _max_leaf_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for k in a for x, y in
               zip(a[k].values(), b[k].values()))


# ------------------------------------------------ port fused vs JAX fused --
@pytest.mark.parametrize("extra", [
    dict(scheduler="dagsa_jit"),
    dict(scheduler="dagsa_jit", compute="selected"),
    dict(scheduler="rs"),
    dict(scheduler="ucb"),
], ids=["dagsa_jit", "dagsa_jit_selected", "rs", "ucb"])
def test_fused_run_matches_live_jax_fused_run(extra):
    check_run_against_live_jax(extra, mode="fused", port_mode="fused")


# ------------------------------------------- port fused = step = eager --
@functools.cache
def _mode_runs() -> dict:
    """The port's three runs of the default config, 3 rounds a mode:
    mode -> (sim, records)."""
    out = {}
    for mode in ("fused", "step", "eager"):
        sim = _sim(scheduler="dagsa_jit")
        out[mode] = sim, sim.run(3, mode=mode)
    return out


@pytest.mark.parametrize("mode", ["step", "eager"])
def test_fused_matches_step_and_eager(mode):
    """The port of JAX's test_fused_scan_matches_legacy_loop: the same
    decisions, t_round / wall_clock / min_part_rate within rtol 1e-6, the
    final parameters within 1e-5, the record bookkeeping as eager's."""
    runs = _mode_runs()
    f_sim, fused = runs["fused"]
    sim, got = runs[mode]
    assert [r.n_selected for r in got] == [r.n_selected for r in fused]
    for field in ("t_round", "wall_clock", "min_part_rate"):
        np.testing.assert_allclose([getattr(r, field) for r in got],
                                   [getattr(r, field) for r in fused],
                                   rtol=1e-6, err_msg=field)
    assert _max_leaf_diff(sim.params, f_sim.params) <= 1e-5
    for r_f, r_m in zip(fused, got):
        assert r_f.round_idx == r_m.round_idx
        np.testing.assert_allclose(r_f.test_acc, r_m.test_acc, atol=1e-6)


def test_fused_run_is_resumable():
    """Two fused run() calls chain the state as one long run does."""
    once = _sim(scheduler="dagsa_jit")
    recs_once = once.run(4, mode="fused")
    split = _sim(scheduler="dagsa_jit")
    recs_split = split.run(2, mode="fused") + split.run(2, mode="fused")
    assert [r.n_selected for r in recs_split] == \
           [r.n_selected for r in recs_once]
    np.testing.assert_allclose([r.wall_clock for r in recs_split],
                               [r.wall_clock for r in recs_once], rtol=1e-6)
    assert [r.round_idx for r in recs_split] == [1, 2, 3, 4]
    assert _max_leaf_diff(split.params, once.params) <= 1e-6
    # the first three rounds are the mode runs' fused run
    fused = _mode_runs()["fused"][1]
    assert [r.n_selected for r in recs_once[:3]] == \
           [r.n_selected for r in fused]


def test_run_round_is_one_step():
    """run_round() is one step of the run (records equal to run(1)'s)."""
    sim = _sim(scheduler="dagsa_jit")
    rec = sim.run_round()
    want = _mode_runs()["step"][1][0]
    np.testing.assert_equal(dataclasses.asdict(rec), dataclasses.asdict(want))
    assert sim.round_idx == 1


# ----------------------------------------------------------- refusals --
def _j_sim(**extra) -> JSimulation:
    with jax.threefry_partitionable(True):
        return JSimulation(JConfig(wireless=JWireless(**W), **ENGINE_SYNC,
                                   **extra))


_REFUSALS = [
    ("host_fused", dict(scheduler="dagsa"), "fused", "does not trace"),
    ("host_step", dict(scheduler="dagsa"), "step", "does not trace"),
    ("eager_hier", dict(scheduler="dagsa_jit", aggregation="hierarchical",
                        tau_global=2), "eager",
     "aggregation='hierarchical' lives in the traced round step"),
    ("eager_compress", dict(scheduler="dagsa_jit", compress="topk",
                            topk_frac=0.5), "eager",
     "compressed uplink / device heterogeneity"),
    ("eager_hetero", dict(scheduler="dagsa_jit", scenario="hetero-compute"),
     "eager", "compressed uplink / device heterogeneity"),
    ("eager_stateful", dict(scheduler="ucb"), "eager",
     "stateful scheduler 'ucb'"),
    ("async_fused", dict(scheduler="dagsa_jit", aggregation_async=True,
                         tick_s=0.5), "fused", "runs mode='async' only"),
    ("async_step", dict(scheduler="dagsa_jit", aggregation_async=True,
                        tick_s=0.5), "step", "runs mode='async' only"),
    ("sync_async", dict(scheduler="dagsa_jit"), "async",
     "mode='async' needs"),
]


@pytest.mark.parametrize("extra,mode,fragment",
                         [r[1:] for r in _REFUSALS],
                         ids=[r[0] for r in _REFUSALS])
def test_mode_refusals_are_jaxs(extra, mode, fragment):
    """Each refusal of JAX's run() raises here too, with JAX's message."""
    with pytest.raises(ValueError, match=fragment.replace("(", r"\(")) as j:
        with jax.threefry_partitionable(True):
            _j_sim(**extra).run(1, mode=mode)
    with pytest.raises(ValueError) as t:
        _sim(**extra).run(1, mode=mode)
    assert str(t.value) == str(j.value)


def test_unknown_mode_is_refused():
    with pytest.raises(ValueError, match="unknown mode 'scan'"):
        _sim(scheduler="dagsa_jit").run(1, mode="scan")


@pytest.mark.parametrize("extra,want", [
    (dict(scheduler="dagsa"), "eager"),
    (dict(scheduler="dagsa-r-host"), "eager"),
    (dict(scheduler="dagsa_jit"), "fused"),
    (dict(scheduler="ucb"), "fused"),
    (dict(scheduler="fedcs_high"), "fused"),
    (dict(scheduler="dagsa-r", aggregation_async=True, tick_s=0.5), "async"),
], ids=["dagsa", "dagsa-r-host", "dagsa_jit", "ucb", "fedcs_high", "async"])
def test_default_mode_is_jaxs(extra, want):
    """mode=None resolves as JAX's: async, else fused for a scheduler in
    FUSED_SCHEDULERS (the same tuple), else eager."""
    assert t_rounds.FUSED_SCHEDULERS == J_FUSED
    sim = _sim(**extra)
    assert sim.fused_capable == (extra["scheduler"] in J_FUSED)
    assert sim._resolve_mode(None) == want


def test_fl_sim_mode_flag_is_jaxs(monkeypatch):
    """fl_sim --mode: JAX's choices and default, passed to run()."""
    def choices(main, argv):
        seen = {}

        class Parsed(Exception):
            pass

        def parse_args(self, args=None, namespace=None):
            act = next(a for a in self._actions if a.dest == "mode")
            seen["choices"] = tuple(act.choices)
            raise Parsed

        with monkeypatch.context() as m:
            m.setattr(fl_sim.argparse.ArgumentParser, "parse_args",
                      parse_args)
            with pytest.raises(Parsed):
                main(*argv)
        return seen["choices"]

    assert choices(fl_sim.main, ([],)) == choices(j_fl_sim.main, ()) == \
        ("fused", "step", "eager")
    port = _parser_default(fl_sim.main, ([],), "mode", monkeypatch)
    ref = _parser_default(j_fl_sim.main, (), "mode", monkeypatch)
    assert port is ref is None
    monkeypatch.undo()

    class Ran(Exception):
        pass

    def run(self, n, mode=None):
        raise Ran(mode)

    monkeypatch.setattr(FLSimulation, "run", run)
    with pytest.raises(Ran, match="step"):
        fl_sim.main(["--device", "cpu", "--scheduler", "rs", "--rounds",
                     "1", "--n-test", "20", "--mode", "step"])


# --------------------------------------------------- capture safety --
class _NoHostTraffic(TorchDispatchMode):
    """Fails on an op a CUDA graph capture refuses on the card: a read of a
    device value on the host (``.item()``, ``bool()``, a boolean-mask
    index, ``nonzero``, ``unique``) or a tensor made from host data
    (``torch.tensor``, ``torch.as_tensor`` of a number: a copy from the
    host).  The greedy's host loop test is the one read allowed: on the
    card it is the graph's WHILE node."""

    SYNC = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten.lift_fresh", "aten.unique", "aten._unique2",
            "aten.unique_consecutive", "aten.unique_dim", "aten.item"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        bad = name in self.SYNC
        if name in ("aten.index", "aten.index_put", "aten.index_put_"):
            bad = any(t is not None and t.dtype == torch.bool
                      for t in args[1])
        if name == "aten.repeat_interleave":
            bad = kwargs.get("output_size") is None
        if bad:
            raise AssertionError(f"{func}: a host sync or a host copy")
        return func(*args, **kwargs)


def _loop_test(go):
    with _disable_current_modes():
        return bool(go)


_ASYNC = dict(aggregation_async=True, tick_s=0.5, staleness_alpha=0.5)


@pytest.mark.parametrize("extra", [
    dict(), dict(compute="selected"), dict(scheduler="dagsa-r",
                                           faults="faulty-uplink"),
    dict(scheduler="rs"), dict(scheduler="ub"), dict(scheduler="sa"),
    dict(scheduler="fedcs_low"), dict(scheduler="ucb"), dict(scheduler="pf"),
    dict(scheduler="rr"), dict(scheduler="biased-adaptive"),
    dict(aggregation="hierarchical", tau_global=2, compress="topk-int8",
         topk_frac=0.1, compute="selected"),
    dict(compress="topk", topk_frac=0.2),
    dict(scenario="hetero-compute"), dict(scenario="waypoint"),
    dict(_ASYNC),
    dict(_ASYNC, scheduler="dagsa-r", faults="faulty-uplink"),
    dict(_ASYNC, compute="selected"),
    dict(_ASYNC, compress="topk", topk_frac=0.2),
], ids=["sync", "selected", "faulty", "rs", "ub", "sa", "fedcs", "ucb",
        "pf", "rr", "biased", "hier_int8_selected", "topk", "hetero",
        "waypoint", "async", "faulty_async", "async_selected",
        "async_topk"])
def test_fused_step_keeps_off_the_host(extra, monkeypatch):
    """Two fused rounds (the second a global sync on hierarchical runs) or
    two async ticks (the tick index read from the device) with no host
    sync and no host-to-device copy."""
    sim = _sim(**{"scheduler": "dagsa_jit", **extra})
    monkeypatch.setattr(graph_while, "_host_test", _loop_test)
    state = sim._state
    with _NoHostTraffic():
        for r in (0, 1):
            state, _ = sim._step_fn(state, r, torch.full((), float(r)))


_SWEEP_KW = dict(cfg=WirelessConfig(**W), n_seeds=2, n_rounds=2,
                 n_train=120, n_test=40, local_epochs=1, batch_size=10,
                 seed=7, device="cpu")


@pytest.mark.parametrize("extra", [
    dict(), dict(aggregation="hierarchical", tau_global=2),
    dict(scheduler="dagsa-r", faults="faulty-uplink", **_ASYNC),
], ids=["sync", "hier", "faulty_async"])
def test_sweep_bucket_step_keeps_off_the_host(extra, monkeypatch):
    """A learning bucket's step over its two cells (one scenario, two
    seeds), what the card captures, makes no host sync and no host copy
    in two rounds (hierarchical: both patterns, the second a global
    sync).  tests/test_torch_cuda.py holds the captured bucket's records
    to the host route's."""
    from repro_torch.launch import sweep

    monkeypatch.setattr(graph_while, "_host_test", _loop_test)
    seen = []

    def checked(states, step_fn, pattern, n_rounds, dev):
        def step(states, r, r_dev=None):
            seen.append((len(states), pattern(r)))
            with _NoHostTraffic():
                return step_fn(states, r, torch.full((), float(r)))
        return sweep._run_bucket_host(states, step, pattern, n_rounds, dev)

    monkeypatch.setattr(sweep, "_run_bucket", checked)
    sweep.run_learning_sweep(["paper-default"], **_SWEEP_KW, **extra)
    hier = "aggregation" in extra
    assert seen == [(2, (True, False)), (2, (True, hier))]


# one bucket at 12 users x 4 BSs: the three mobility models, both BS
# layouts, a shadowed world and spread bandwidths
_WIRELESS = ["paper-default", "static", "shadowed", "waypoint", "hetero-bw"]
_WIRELESS_KW = dict(cfg=WirelessConfig(**W), n_seeds=2, n_rounds=2, seed=7,
                    device="cpu")


@pytest.mark.parametrize("names,extra", [
    (_WIRELESS, dict()), (_WIRELESS, dict(channel_dtype="bf16")),
    (_WIRELESS, dict(channel_dtype="int8")),
    (["shadowed", "waypoint"], dict(user_chunk=5)),
], ids=["f32", "bf16", "int8", "chunk5"])
def test_wireless_bucket_step_keeps_off_the_host(names, extra, monkeypatch):
    """A wireless bucket's step over its cells (every scenario x 2 seeds),
    what the card captures, makes no host sync and no host copy in two
    rounds but the greedy's loop test; one pattern.  tests/
    test_torch_cuda.py holds the captured bucket's records to the host
    route's."""
    from repro_torch.launch import sweep

    monkeypatch.setattr(graph_while, "_host_test", _loop_test)
    seen = []

    def checked(states, step_fn, pattern, n_rounds, dev):
        def step(states, r, r_dev=None):
            seen.append((len(states[0]), pattern(r)))
            with _NoHostTraffic():
                return step_fn(states, r, torch.full((), float(r)))
        return sweep._run_bucket_host(states, step, pattern, n_rounds, dev)

    monkeypatch.setattr(sweep, "_run_bucket", checked)
    sweep.run_sweep(names, **_WIRELESS_KW, **extra)
    assert seen == [(2 * len(names), ())] * 2


@pytest.mark.parametrize("names,extra", [
    (_WIRELESS, dict()), (["shadowed", "waypoint"], dict(user_chunk=5)),
], ids=["f32", "chunk5"])
def test_wireless_bucket_step_reads_the_round_from_the_device(names, extra,
                                                              monkeypatch):
    """A captured round replays with the Python round index of its capture
    (0) and only the device index filled: the wireless bucket step run so,
    five rounds, gives ``run_sweep``'s records (the Eq. (8g) floor and the
    fairness monitor read the round from the device)."""
    from repro_torch.launch import sweep

    kw = dict(_WIRELESS_KW, n_rounds=5, **extra)
    want = sweep.run_sweep(names, **kw)

    def frozen(states, step_fn, pattern, n_rounds, dev):
        outs = []
        for r in range(n_rounds):
            states, out = step_fn(states, 0, torch.full((), float(r)))
            outs.append(out)
        return {k: torch.stack([o[k] for o in outs], dim=-1)
                for k in outs[0]}

    monkeypatch.setattr(sweep, "_run_bucket", frozen)
    got = sweep.run_sweep(names, **kw)
    assert got == want


def test_async_run_equals_run_round_ticks():
    """run(n, mode="async") takes the ticks of n run_round() calls: the
    records equal, the parameters bit-equal."""
    extra = dict(_ASYNC, scheduler="dagsa-r", faults="faulty-uplink")
    whole = _sim(**extra)
    recs = whole.run(3, mode="async")
    ticks = _sim(**extra)
    got = [ticks.run_round() for _ in range(3)]
    np.testing.assert_equal([dataclasses.asdict(r) for r in got],
                            [dataclasses.asdict(r) for r in recs])
    assert [r.round_idx for r in got] == [1, 2, 3] and ticks.round_idx == 3
    assert any(r.n_delivered > 0 for r in got)
    for k in whole.params:
        for leaf in whole.params[k]:
            assert torch.equal(whole.params[k][leaf],
                               ticks.params[k][leaf]), (k, leaf)


# ------------------------------------------- the greedy's device loop --
@pytest.mark.parametrize("n,m", [(12, 4), (50, 8), (30, 1), (40, 5)])
def test_greedy_keeps_off_the_host(n, m, monkeypatch):
    """The greedy reads nothing on the host but its loop test (on the card
    a WHILE node's test), one test a pass of the fleet's longest greedy
    plus the last: test_torch_dagsa's 80 problems, one at a time and as a
    fleet of 20 (tests/test_torch_cuda.py holds the captured loop to the
    uncaptured one on the same problems)."""
    probs = [_problem(seed, n, m) for seed in range(20)]
    keys = torch.stack([torch.tensor([0, seed], dtype=torch.int64)
                        for seed in range(20)])
    passes = []

    def counted_test(go):
        passes.append(1)
        return _loop_test(go)

    monkeypatch.setattr(graph_while, "_host_test", counted_test)
    cols = list(zip(*probs))
    for i in list(range(20)) + [None]:
        pick = ((lambda c: torch.from_numpy(np.stack(c))) if i is None else
                (lambda c, i=i: torch.from_numpy(np.asarray(c[i]))[None]))
        snr, coeff, tcomp, bs_bw, nec = (pick(c) for c in cols[:5])
        passes.clear()
        with _NoHostTraffic():
            assign = dagsa_jit._schedule_batch(
                snr, coeff, tcomp, bs_bw, nec, probs[0][5],
                keys if i is None else keys[i][None])[0]
        # a pass adds one user to each live problem: one test a pass of
        # the fleet's longest greedy, plus the last
        steps = assign.any(dim=-1).sum(dim=-1) - nec.sum(dim=-1)
        assert len(passes) == int(steps.max()) + 1, (i, len(passes))


def test_captured_launches_are_added_per_replay():
    """A capture's launches leave the counts as they were and come back
    once a replay (the launch accounting of a fused run)."""
    _lib.reset_launches()
    _lib.LAUNCHES["fedavg_reduce"] = 3
    with _lib.captured_launches() as got:
        _lib.LAUNCHES["fedavg_reduce"] += 2
        _lib.LAUNCHES["bandwidth_solve"] += 5
    assert _lib.LAUNCHES["fedavg_reduce"] == 3
    assert _lib.LAUNCHES["bandwidth_solve"] == 0
    _lib.add_launches(got, 4)
    assert _lib.LAUNCHES["fedavg_reduce"] == 11
    assert _lib.LAUNCHES["bandwidth_solve"] == 20
    _lib.reset_launches()
