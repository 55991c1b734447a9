"""``compute="selected"`` in the port against the JAX package.

Each round trains a static-size gather of the scheduled clients
(``client.topk_selected_indices``: scheduled first in index order, the
unscheduled padding the tail) instead of the whole fleet.

* the gather's indices and ``resolve_cap`` equal JAX's exactly;
* three engine runs against live JAX runs in the ``engine_sync`` world
  (12 users, 4 BSs, 120 / 40 samples, 1 local epoch, batch 10, seed 7,
  ``dagsa_jit``), each with a cap that cuts the selection in at least one
  round: (a) sync under outages, NaN poisoning and the norm clip, 2 rounds
  (ROADMAP C.8); (b) hierarchical over the top-k + int8 uplink, 3 rounds;
  (c) buffered-async over the top-k uplink, ``select_cap=4``, 4 ticks.
  Tolerances are ``tests/test_torch_slice.py::check_run_against_live_jax``'s:
  decisions and counts exact, ``t_round`` rtol 1e-5, parameters rtol 1e-4,
  atol 1e-5 (the int8 uplink plus test_torch_compress.py's one-int8-step
  allowance);
* a learning sweep (2 scenarios x 2 seeds x 2 rounds, ``select_cap=4``)
  against a live JAX sweep, as ``tests/test_torch_sweep.py`` holds sweeps;
* port against port: a covering cap (``select_cap=N``) against
  ``compute="full"``, at the bounds JAX's own tests hold (sync 1e-5,
  ``tests/test_fl.py``; hierarchical equal, ``tests/test_hfl.py``; async
  records and parameters equal, ``tests/test_async.py``);
* ``fl_sim --compute selected --select-cap 4`` on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.fl import faults as j_faults  # noqa: E402
from repro.launch import sweep as j_sweep  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl import client, faults  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation  # noqa: E402
from repro_torch.interop import params_to_numpy  # noqa: E402
from repro_torch.launch import fl_sim, sweep  # noqa: E402

from test_torch_compress import _flip_budget, assert_params_close  # noqa: E402
from test_torch_slice import ENGINE_SYNC, check_run_against_live_jax  # noqa: E402
from test_torch_sweep import LEARN, _check_learning  # noqa: E402
from test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

W12 = dict(n_users=12, n_bs=4)
# faulty-uplink's outages with adversarial-updates' NaN poisoning and clip
MIXED_FAULTS = dict(outage_base=0.05, outage_edge=0.5, outage_handover=0.4,
                    corrupt_prob=0.15, corrupt_mode="nan", clip_norm=25.0)


# ------------------------------------------------------------ the gather --
@pytest.mark.parametrize("case,n,cap", [
    ("none", 12, 5), ("all", 12, 5), ("cap_above", 12, 9),
    ("cap_below", 12, 3), ("cap_n", 12, 12), ("cap_over_n", 12, 40),
    ("large", 1000, 100)])
def test_topk_selected_indices_match_jax(case, n, cap):
    rs = np.random.default_rng(n + cap)
    mask = {"none": np.zeros(n, bool), "all": np.ones(n, bool)}.get(
        case, rs.random(n) < 0.45)
    k = client.resolve_cap(n, cap)
    assert k == j_client.resolve_cap(n, cap) == min(cap, n)
    assert client.resolve_cap(n, None) == j_client.resolve_cap(n, None) == n
    got = client.topk_selected_indices(torch.from_numpy(mask), k)
    want = np.asarray(j_client.topk_selected_indices(jnp.asarray(mask), k))
    np.testing.assert_array_equal(got.numpy(), want)
    n_sel = int(mask.sum())
    if case == "cap_above":
        assert n_sel < k
    if case == "cap_below":
        assert n_sel > k
    # the scheduled clients first, in index order, then the padding
    assert got.numpy()[:min(n_sel, k)].tolist() == \
        np.flatnonzero(mask)[:k].tolist()


def test_config_guards_mirror_jax():
    with pytest.raises(ValueError, match="unknown compute mode"):
        FLConfig(compute="sparse")
    # a cap with compute="full" is accepted and does nothing, as in JAX
    assert FLConfig(select_cap=3).compute == "full"
    # JAX runs the host greedies in its eager round, which trains the
    # whole fleet whatever the compute mode: so does the port (the default
    # cap, ceil(rho2 * N): test_sync_selected_with_faults_matches_live_jax)
    host = FLSimulation(FLConfig(wireless=WirelessConfig(**W12),
                                 compute="selected", **ENGINE_SYNC),
                        device="cpu")
    assert (host.cfg.scheduler, host.compute, host.select_cap) == \
        ("dagsa", "full", 6)
    with pytest.raises(ValueError, match="unknown compute mode"):
        sweep.run_learning_sweep(["paper-default"], compute="sparse",
                                 device="cpu")


# ------------------------------------------- engine runs against live JAX --
def _cut(recs, cap):
    """The cap left scheduled (async: dispatched) clients out of a round."""
    return any(r.n_selected > cap for r in recs)


def test_sync_selected_with_faults_matches_live_jax():
    """(a): outages drop uploads (``delivered[idx]``), NaN poisoning hits
    the gathered rows (``corrupt[idx]``) and the clip reweights them."""
    extra = dict(scheduler="dagsa_jit", compute="selected",
                 faults=faults.FaultSpec(**MIXED_FAULTS))
    sim, recs = check_run_against_live_jax(
        extra, rounds=2,
        jax_extra=dict(faults=j_faults.FaultSpec(**MIXED_FAULTS)))
    assert sim.select_cap == 6 and _cut(recs, sim.select_cap)  # ceil(rho2 N)
    assert sum(r.n_selected - r.n_delivered for r in recs) > 0
    assert sim.faults.clip_norm == 25.0


def test_hier_int8_selected_matches_live_jax(monkeypatch, record_property):
    """(b): the serving cells gathered first, the compressed segment
    reduction over [cap] rows; global and edge models."""
    steps = _flip_budget(monkeypatch)
    extra = dict(scheduler="dagsa_jit", compute="selected",
                 aggregation="hierarchical", tau_global=2,
                 compress="topk-int8", topk_frac=0.1)
    sim, recs = check_run_against_live_jax(
        extra, edges=True, params_check=lambda got, want: assert_params_close(
            [got], [want], steps, record_property))
    assert _cut(recs, sim.select_cap)


def test_async_topk_selected_matches_live_jax():
    """(c): training and the queue admit on [4] rows, the top-k screen
    scattered back onto the [N] dispatch mask."""
    extra = dict(scheduler="dagsa_jit", compute="selected", select_cap=4,
                 compress="topk", topk_frac=0.25, aggregation_async=True,
                 tick_s=0.5, staleness_alpha=0.5)
    sim, recs = check_run_against_live_jax(extra, rounds=4)
    assert _cut(recs, 4)
    assert sum(r.n_delivered for r in recs) > 0


def test_learning_sweep_selected_matches_live_jax():
    names = ["paper-default", "high-mobility"]
    kw = dict(LEARN, n_rounds=2, compute="selected", select_cap=4)
    with jax.threefry_partitionable(True):
        want = j_sweep.run_learning_sweep(names, cfg=JWireless(**W12), **kw)
    got = sweep.run_learning_sweep(names, cfg=WirelessConfig(**W12),
                                   device="cpu", **kw)
    _check_learning(want, got)
    assert max(max(r["curves"]["n_selected"]) for r in got) > 4


# ------------------------------------------- a covering cap, port vs port --
def _pair(extra, rounds):
    """The same config with compute="full" and with a covering cap."""
    base = dict(wireless=WirelessConfig(**W12), scheduler="dagsa_jit",
                **ENGINE_SYNC, **extra)
    full = FLSimulation(FLConfig(**base), device="cpu")
    sel = FLSimulation(FLConfig(**base, compute="selected", select_cap=12),
                       device="cpu")
    return full, full.run(rounds), sel, sel.run(rounds)


def _trees(sim):
    out = [params_to_numpy(sim.params)]
    if sim.edge_params is not None:
        out.append(params_to_numpy(sim.edge_params))
    return out


def _max_diff(a, b):
    return max(float(np.max(np.abs(x[k][leaf] - y[k][leaf])))
               for x, y in zip(a, b) for k in x for leaf in x[k])


@pytest.mark.parametrize("kind,extra,bound", [
    ("sync", {}, 1e-5),
    ("hier", dict(aggregation="hierarchical", tau_global=2), 0.0),
    ("async", dict(aggregation_async=True, tick_s=0.5, staleness_alpha=0.5),
     0.0)])
def test_covering_cap_equals_full_compute(kind, extra, bound,
                                          record_property):
    """A cap of N trains every client, scheduled ones first: the records
    equal the full run's and the models agree within JAX's own bound."""
    full, want, sel, got = _pair(extra, 3)
    for g, w in zip(got, want):
        np.testing.assert_equal(dataclasses.asdict(g), dataclasses.asdict(w))
    diff = _max_diff(_trees(sel), _trees(full))
    record_property("max_abs_param_diff", diff)
    assert diff <= bound, (kind, diff)


def test_cli_runs_selected_on_cpu(capsys):
    fl_sim.main(["--device", "cpu", "--scheduler", "dagsa_jit", "--compute",
                 "selected", "--select-cap", "4", "--rounds", "2",
                 "--n-train", "200", "--n-test", "40", "--batch-size", "4",
                 "--local-epochs", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[1:3]] == ["1", "2"]
    assert lines[-1].startswith("acc@")
