"""The buffered-async engine in the port against the JAX package: the
event queue on injected states, the staleness weights, the sentinel-aware
client scatter, the config guards, ``accuracy_at_budget``, the
``engine_async`` and ``engine_faulty_async`` slices (and three more
configs) against live JAX runs, and the ``fl_sim`` CLI's async flags.

Tolerances: queue contents, masks, counts and scattered rows exact;
staleness weights exactly 1.0 at s = 0 and within rtol=1e-6 elsewhere;
engine runs as in test_torch_slice.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.fl import rounds as j_rounds  # noqa: E402
from repro.fl import server as j_server  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl import client, rounds, server  # noqa: E402
from repro_torch.launch import fl_sim  # noqa: E402
from tests.test_torch_compress import (_flip_budget,  # noqa: E402
                                       assert_params_close)
from tests.test_torch_slice import check_run_against_live_jax  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy
ASYNC = dict(aggregation_async=True, tick_s=0.5, staleness_alpha=0.5)


def _tree(rs, rows):
    return {"a": {"w": rs.normal(size=(rows, 3, 2)).astype(np.float32)},
            "b": {"b": rs.normal(size=(rows, 4)).astype(np.float32)}}


def _torch_tree(tree):
    return {k: {leaf: T(np.array(v)) for leaf, v in sub.items()}
            for k, sub in tree.items()}


def _queue_case(case, n=9, seed=0):
    """A queue of capacity b holding live entries from earlier ticks, and
    this tick's dispatch of clients with nothing in flight."""
    rs = np.random.default_rng(seed)
    r, tick = 4, 0.5
    now, tick_end = np.float32(r * tick), np.float32(r * tick + tick)
    b = {"admit": n, "deliver": n, "ties": n, "evict": 3}[case]
    n_live = {"admit": 0, "deliver": 4, "ties": 4, "evict": 2}[case]
    clients = rs.permutation(n)
    comp_q = np.full(b, np.inf, np.float32)
    comp_q[:n_live] = np.sort(rs.uniform(now - 0.2, now + 1.5, n_live))
    comp_q[:min(n_live, 1)] = now + np.float32(0.1)   # lands this tick
    tick_q = np.zeros(b, np.int32)
    tick_q[:n_live] = rs.integers(0, r, n_live)
    idx_q = np.full(b, n, np.int32)
    idx_q[:n_live] = clients[:n_live]
    size_q = np.zeros(b, np.float32)
    size_q[:n_live] = rs.integers(5, 20, n_live)
    upd_q = _tree(rs, b)
    busy = np.zeros(n, bool)
    busy[clients[:n_live]] = True
    dispatch = ~busy & (rs.random(n) < 0.8)
    comp_time = (now + rs.uniform(0.05, 1.2, n)).astype(np.float32)
    if case == "ties":
        # equal completion times among dispatches and with a queued entry,
        # on both sides of the tick's end
        free = np.flatnonzero(dispatch)
        comp_time[free[:3]] = comp_q[1]
        comp_time[free[3:5]] = tick_end + np.float32(0.25)
    if case == "evict":
        comp_time[:] = tick_end + rs.uniform(0.1, 1.0, n).astype(np.float32)
    sizes = rs.integers(5, 20, n).astype(np.int32)
    client_params = _tree(rs, n)
    queue = (comp_q, tick_q, idx_q, size_q, upd_q)
    return queue, client_params, dispatch, comp_time, sizes, r, tick_end, busy


@pytest.mark.parametrize("case", ["admit", "deliver", "ties", "evict"])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_async_queue_step_matches_jax(case, alpha):
    queue, upd, dispatch, comp_time, sizes, r, tick_end, busy = \
        _queue_case(case)
    n = dispatch.shape[0]
    want = j_rounds.async_queue_step(queue, upd, dispatch, comp_time, sizes,
                                     r, tick_end, alpha)
    t_queue = tuple(T(np.array(a)) for a in queue[:4]) + (
        _torch_tree(queue[4]),)
    got = rounds.async_queue_step(t_queue, _torch_tree(upd), T(dispatch),
                                  T(comp_time), T(sizes), r,
                                  torch.tensor(tick_end), alpha)
    np.testing.assert_array_equal(
        rounds.async_busy(t_queue, n).numpy(),
        np.asarray(j_rounds.async_busy(queue, n)))
    np.testing.assert_array_equal(busy, rounds.async_busy(t_queue, n).numpy())
    (wq, w_del, w_wst, w_upd, w_diag) = want
    (gq, g_del, g_wst, g_upd, g_diag) = got
    for i, name in enumerate(("comp", "tick", "idx", "size")):
        np.testing.assert_array_equal(gq[i].numpy(), np.asarray(wq[i]),
                                      err_msg=name)
    for tree_g, tree_w in ((gq[4], wq[4]), (g_upd, w_upd)):
        for k in tree_w:
            for leaf in tree_w[k]:
                np.testing.assert_array_equal(tree_g[k][leaf].numpy(),
                                              np.asarray(tree_w[k][leaf]))
    np.testing.assert_array_equal(g_del.numpy(), np.asarray(w_del))
    np.testing.assert_allclose(g_wst.numpy(), np.asarray(w_wst), rtol=1e-6)
    for key in ("n_delivered", "n_inflight", "n_dropped"):
        assert int(g_diag[key]) == int(w_diag[key]), key
    np.testing.assert_allclose(float(g_diag["w_delivered"]),
                               float(w_diag["w_delivered"]), rtol=1e-6)
    # the case does what it is named for
    assert {"admit": int(g_diag["n_delivered"]) > 0,
            "deliver": int(g_diag["n_delivered"]) > 0
            and int(g_diag["n_inflight"]) > 0,
            "ties": int(g_diag["n_inflight"]) > 1,
            "evict": int(g_diag["n_dropped"]) > 0}[case]


def test_async_queue_init_matches_jax():
    params = {"a": {"w": np.zeros((3, 2), np.float32)}}
    want = j_rounds.async_queue_init(params, 7, 4)
    got = rounds.async_queue_init(_torch_tree(params), 7, 4)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.numpy().dtype == np.asarray(w).dtype
    assert tuple(got[4]["a"]["w"].shape) == want[4]["a"]["w"].shape
    assert not rounds.async_busy(got, 7).any()


def test_staleness_weights_match_jax():
    s = np.arange(0, 12, dtype=np.int32)
    for alpha in (0.0, 0.5, 1.0, 2.3):
        want = np.asarray(j_server.staleness_weights(s, alpha))
        got = server.staleness_weights(T(s), alpha).numpy()
        assert got.dtype == np.float32
        assert got[0] == 1.0
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (server.staleness_weights(T(s), 0.0).numpy() == 1.0).all()


@pytest.mark.parametrize("with_base", [False, True])
def test_scatter_client_tree_matches_jax(with_base):
    """The sentinel n and anything past it drop; -1 counts from the end."""
    rs = np.random.default_rng(2)
    n = 6
    idx = np.array([3, 6, 0, -1, 9, 6, 2], np.int32)
    tree = _tree(rs, len(idx))
    base = _tree(rs, n) if with_base else None
    want = j_client.scatter_client_tree(
        n, idx, tree, jax.tree.map(jax.numpy.asarray, base))
    got = client.scatter_client_tree(
        n, T(idx), _torch_tree(tree),
        _torch_tree(base) if with_base else None)
    for k in want:
        for leaf in want[k]:
            np.testing.assert_array_equal(got[k][leaf].numpy(),
                                          np.asarray(want[k][leaf]))


@pytest.mark.parametrize("bad", [
    dict(aggregation_async=True),
    dict(aggregation_async=True, tick_s=0.0),
    dict(aggregation_async=True, tick_s=1.0, staleness_alpha=-0.5),
    dict(aggregation_async=True, tick_s=1.0, buffer_size=0),
    dict(aggregation_async=True, tick_s=1.0, aggregation="hierarchical"),
    dict(tick_s=1.0), dict(staleness_alpha=0.5), dict(buffer_size=4),
    dict(deadline_s=0.0), dict(faults=3)])
def test_config_guards_mirror_jax(bad):
    with pytest.raises(ValueError) as t_err:
        rounds.FLConfig(scheduler="dagsa_jit", **bad)
    with pytest.raises(ValueError) as j_err:
        j_rounds.FLConfig(scheduler="dagsa_jit", **bad)
    first = lambda e: str(e.value).split()[0]            # noqa: E731
    assert first(t_err) == first(j_err)


def test_async_with_a_host_scheduler_raises_as_in_jax():
    small = dict(n_train=120, n_test=40, local_epochs=1, batch_size=10,
                 aggregation_async=True, tick_s=1.0)
    for name in ("dagsa", "dagsa-r-host"):
        with pytest.raises(ValueError, match="host-side"):
            rounds.FLSimulation(rounds.FLConfig(
                wireless=WirelessConfig(n_users=12, n_bs=4), scheduler=name,
                **small), device="cpu")
        with pytest.raises(ValueError, match="host-side"):
            j_rounds.FLSimulation(j_rounds.FLConfig(
                wireless=JWireless(n_users=12, n_bs=4), scheduler=name,
                **small))
    assert rounds.FLConfig(scheduler="fedcs_low", **small).aggregation_async


def test_accuracy_at_budget_matches_jax():
    rs = np.random.default_rng(4)
    walls = np.cumsum(rs.uniform(0.1, 0.6, 12))
    accs = rs.uniform(0.1, 0.9, 12)
    accs[[2, 7]] = np.nan                                 # not evaluated
    recs_t = [rounds.RoundRecord(i + 1, 0.1, float(w), 5, float(a), 0.5)
              for i, (w, a) in enumerate(zip(walls, accs))]
    recs_j = [j_rounds.RoundRecord(**dataclasses.asdict(r)) for r in recs_t]
    for budget in (0.0, walls[2], walls[5] + 1e-3, walls[-1], 1e9):
        want = j_rounds.accuracy_at_budget(recs_j, budget)
        got = rounds.accuracy_at_budget(recs_t, budget)
        assert got == want or (np.isnan(got) and np.isnan(want))
    assert [f.name for f in dataclasses.fields(rounds.RoundRecord)] == \
        [f.name for f in dataclasses.fields(j_rounds.RoundRecord)]


@pytest.mark.parametrize("extra", [
    dict(scheduler="dagsa_jit", **ASYNC),
    dict(scheduler="dagsa-r", faults="faulty-uplink", **ASYNC),
    dict(scheduler="dagsa_jit", aggregation_async=True, tick_s=0.3,
         staleness_alpha=0.5, buffer_size=3),
    dict(scheduler="fedcs_high", faults="adversarial-updates", **ASYNC),
    dict(scheduler="ub", compress="topk-int8", topk_frac=0.1, **ASYNC),
], ids=["engine_async", "engine_faulty_async", "evicting_buffer",
        "fedcs_adversarial_async", "ub_int8_async"])
def test_async_engine_matches_live_jax_run(extra, monkeypatch,
                                          record_property):
    """``engine_async`` and ``engine_faulty_async`` are the golden cases
    (JAX's ``mode="async"`` scan, 3 ticks of 0.5 s, alpha 0.5).  The int8
    uplink's parameters get test_torch_compress.py's one-int8-step
    allowance on at most 12 entries (a code at a rounding boundary)."""
    check = None
    if extra.get("compress") == "topk-int8":
        steps = _flip_budget(monkeypatch)
        check = lambda got, want: assert_params_close(  # noqa: E731
            [got], [want], steps, record_property)
    sim, recs = check_run_against_live_jax(extra, params_check=check)
    assert all(r.t_round == np.float32(extra["tick_s"]) for r in recs)
    assert all(r.n_inflight >= 0 and r.n_dropped >= 0 for r in recs)
    if "buffer_size" in extra:
        assert sum(r.n_dropped for r in recs) > 0


def test_cli_runs_faulty_async_on_cpu(capsys):
    fl_sim.main(["--device", "cpu", "--rounds", "3", "--n-train", "200",
                 "--n-test", "40", "--batch-size", "4", "--local-epochs",
                 "1", "--scheduler", "dagsa-r", "--faults", "faulty-uplink",
                 "--async", "--tick", "0.5", "--staleness-alpha", "0.5"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].split() == ["round", "t_round", "clock", "users", "acc",
                              "min_fair", "deliv", "del_rate", "goodput",
                              "inflight", "dropped"]
    assert [ln.split()[0] for ln in out[1:4]] == ["1", "2", "3"]
    assert all(ln.split()[1] == "0.500" for ln in out[1:4])
    assert out[5].startswith("acc@0.8s = ")
    assert out[6].startswith("delivered_rate mean = ")
    with pytest.raises(SystemExit):
        fl_sim.main(["--device", "cpu", "--async"])      # needs --tick
    with pytest.raises(SystemExit):
        fl_sim.main(["--device", "cpu", "--tick", "0.5"])  # needs --async
