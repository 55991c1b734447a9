"""The fault layer in the port against the JAX package: ``FaultSpec`` and
its presets, the outage / delivery estimates, the per-round fault draws,
poisoned updates, every ``core.latency`` function, the scenario registry
core, ``delivery_discounted``, and faulty engine runs against live JAX
runs (``engine_faulty`` and four more configs).

Tolerances: masks, decisions and counts exact; float functions of the
same inputs within rtol=1e-6 (``edge_proximity``: JAX's jit turns the
division by the cell radius into a multiply by its float32 reciprocal,
ROADMAP C.9); the straggler factor within rtol=1e-6 (the normal draw
is not bit-exact, ROADMAP C.4); engine runs as in test_torch_slice.py.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import latency as j_latency  # noqa: E402
from repro.core import scenario as j_scenario  # noqa: E402
from repro.core import scheduler as j_sched  # noqa: E402
from repro.core.types import ScheduleResult as JResult  # noqa: E402
from repro.core.types import SchedulingProblem as JProblem  # noqa: E402
from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.fl import faults as j_faults  # noqa: E402
from repro_torch.core import latency, scenario  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core.types import ScheduleResult as TResult  # noqa: E402
from repro_torch.core.types import SchedulingProblem as TProblem  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl import faults  # noqa: E402
from repro_torch.interop import key_from_numpy, params_to_numpy  # noqa: E402
from tests.test_torch_slice import check_run_against_live_jax  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy
ALL_ON = dict(outage_base=0.1, outage_edge=0.3, outage_handover=0.2,
              straggler_sigma=0.8, crash_prob=0.05, corrupt_prob=0.15,
              corrupt_mode="scale", corrupt_scale=50.0, deadline_s=1.5,
              clip_norm=25.0)


def _geometry(seed, n=40, m=8):
    rs = np.random.default_rng(seed)
    dist = rs.uniform(1.0, 900.0, (n, m)).astype(np.float32)
    serving = dist.argmin(axis=1).astype(np.int32)
    prev = rs.integers(-1, m, n).astype(np.int32)
    return dist, serving, (serving != prev) & (prev >= 0)


# ------------------------------------------------------------- FaultSpec --
@pytest.mark.parametrize("bad, field", [
    (dict(outage_base=1.5), "outage_base"), (dict(crash_prob=-0.1),
                                             "crash_prob"),
    (dict(outage_handover=2.0), "outage_handover"),
    (dict(straggler_sigma=-1.0), "straggler_sigma"),
    (dict(corrupt_mode="zero"), "corrupt_mode"),
    (dict(deadline_s=0.0), "deadline_s"), (dict(clip_norm=0.0), "clip_norm")])
def test_faultspec_validation_matches_jax(bad, field):
    for spec in (faults.FaultSpec, j_faults.FaultSpec):
        with pytest.raises(ValueError, match=field):
            spec(**bad)


def test_faultspec_active_json_presets_and_params_match_jax():
    specs = [dict(), dict(straggler_sigma=0.5), dict(deadline_s=2.0),
             dict(clip_norm=1.0), ALL_ON] + [
        {f: 0.1} for f in ("outage_base", "outage_edge", "outage_handover",
                           "crash_prob", "corrupt_prob")]
    for kw in specs:
        t, j = faults.FaultSpec(**kw), j_faults.FaultSpec(**kw)
        assert t.active == j.active
        assert t.to_json() == j.to_json()
        json.dumps(t.to_json(), allow_nan=False)
        assert faults.fault_params(t) == j_faults.fault_params(j)
    assert not faults.NO_FAULTS.active
    assert faults.FAULT_PARAM_KEYS == j_faults.FAULT_PARAM_KEYS
    assert faults.CORRUPT_MODES == j_faults.CORRUPT_MODES
    assert tuple(faults.FAULT_PRESETS) == tuple(j_faults.FAULT_PRESETS)
    for name in faults.FAULT_PRESETS:
        assert (dataclasses.asdict(faults.get_faults(name))
                == dataclasses.asdict(j_faults.get_faults(name)))
    for get in (faults.get_faults, j_faults.get_faults):
        with pytest.raises(ValueError, match="unknown fault preset"):
            get("nope")


def test_fault_scenarios_match_jax_field_by_field():
    for name in ("faulty-uplink", "straggler-heavy", "adversarial-updates"):
        t, j = scenario.get_scenario(name), j_scenario.get_scenario(name)
        for f in dataclasses.fields(j_scenario.ScenarioSpec):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if f.name == "faults":
                assert tv is faults.FAULT_PRESETS[name]
                assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
            else:
                assert tv == jv, (name, f.name)
    with pytest.raises(ValueError, match="unknown scenario"):
        scenario.get_scenario("no-such-world")
    with pytest.raises(ValueError, match="already registered"):
        scenario.register_scenario(scenario.get_scenario("faulty-uplink"))
    for bad in (dict(mobility="teleport"), dict(bw_min_mhz=0.5),
                dict(tau_global=2), dict(compute_spread=0.5),
                dict(partition="dirichlet"), dict(topk_frac=0.5),
                dict(faults=3), dict(gm_memory=1.0)):
        with pytest.raises(ValueError):
            scenario.ScenarioSpec(name="x", **bad)
        with pytest.raises(ValueError):
            j_scenario.ScenarioSpec(name="x", **bad)


# -------------------------------------------------- estimates and draws --
@pytest.mark.parametrize("preset", ["faulty-uplink", "all_on"])
def test_outage_delivery_and_edge_proximity_match_jax(preset):
    spec = (faults.FaultSpec(**ALL_ON) if preset == "all_on"
            else faults.FAULT_PRESETS[preset])
    fp = faults.fault_params(spec)
    cfg = WirelessConfig(n_users=40, n_bs=8)
    for seed in range(3):
        dist, serving, hand = _geometry(seed)
        assert faults.nominal_cell_radius(cfg) == \
            j_faults.nominal_cell_radius(JWireless(n_users=40, n_bs=8))
        e_want = np.array(j_faults.edge_proximity(
            dist, serving, JWireless(n_users=40, n_bs=8)))
        e_got = faults.edge_proximity(T(dist), T(serving), cfg).numpy()
        np.testing.assert_allclose(e_got, e_want, rtol=1e-6)
        for fn in ("outage_probability", "delivery_probability"):
            want = np.asarray(getattr(j_faults, fn)(fp, e_want, hand))
            got = getattr(faults, fn)(fp, T(e_want), T(hand)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=fn)


@pytest.mark.parametrize("seed", range(4))
def test_sample_round_faults_match_jax(seed):
    """alive and corrupt bit-exact; tcomp_eff within rtol=1e-6."""
    fp = faults.fault_params(faults.FaultSpec(**ALL_ON))
    dist, serving, hand = _geometry(seed, n=257)
    edge = np.clip(dist[np.arange(257), serving] / 180.0, 0, 1
                   ).astype(np.float32)
    tcomp = np.random.default_rng(seed).uniform(0.1, 0.11, 257
                                                ).astype(np.float32)
    with jax.threefry_partitionable(True):
        jkey = jax.random.PRNGKey(seed)
        want = j_faults.sample_round_faults(jkey, fp, edge, hand, tcomp)
    got = faults.sample_round_faults(key_from_numpy(np.asarray(jkey)), fp,
                                     T(edge), T(hand), T(tcomp))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[1].sum() < 257 and 0 < got[2].sum() < 257


@pytest.mark.parametrize("mode", faults.CORRUPT_MODES)
def test_corrupt_updates_match_jax(mode):
    rs = np.random.default_rng(1)
    tree = {"a": {"w": rs.normal(size=(6, 3, 2)).astype(np.float32)},
            "b": {"b": rs.normal(size=(6, 4)).astype(np.float32)}}
    flag = np.array([False, True, False, True, True, False])
    mode_id = faults.CORRUPT_MODES.index(mode)
    want = j_faults.corrupt_updates(tree, flag, mode_id, 1e3)
    got = faults.corrupt_updates(
        {k: {leaf: T(v) for leaf, v in sub.items()}
         for k, sub in tree.items()}, T(flag), mode_id, 1e3)
    for k in tree:
        for leaf in tree[k]:
            np.testing.assert_array_equal(got[k][leaf].numpy(),
                                          np.asarray(want[k][leaf]))


# --------------------------------------------------------------- latency --
def _latency_case(seed, n=30, m=4):
    rs = np.random.default_rng(seed)
    coeff = rs.uniform(0.02, 0.3, (n, m)).astype(np.float32)
    tcomp = rs.uniform(0.1, 0.11, n).astype(np.float32)
    bs = rs.integers(0, m, n)
    selected = rs.random(n) < 0.6
    assign = np.eye(m, dtype=bool)[bs] & selected[:, None]
    bw = np.where(selected, rs.uniform(0.05, 0.4, n), 0.0).astype(np.float32)
    common = dict(snr=np.ones((n, m), np.float32), tcomp=tcomp,
                  bs_bw=np.ones(m, np.float32), coeff=coeff,
                  necessary=np.zeros(n, bool), min_participants=1)
    res = dict(assign=assign, selected=selected, bw=bw,
               bs_time=np.zeros(m, np.float32), t_round=np.float32(0))
    jp, jr = JProblem(**common), JResult(**res)
    tp = TProblem(**{k: T(v) if isinstance(v, np.ndarray) else v
                     for k, v in common.items()})
    tr = TResult(**{k: T(np.asarray(v)) for k, v in res.items()})
    t_eff = (tcomp * rs.lognormal(0, 0.8, n)).astype(np.float32)
    return jp, jr, tp, tr, t_eff, selected


@pytest.mark.parametrize("seed", range(3))
def test_latency_functions_match_jax(seed):
    jp, jr, tp, tr, t_eff, selected = _latency_case(seed)
    for fn, args_j, args_t in (
            ("upload_latency", (jp, jr), (tp, tr)),
            ("round_latency", (jp, jr), (tp, tr)),
            ("per_user_latency", (jp, jr), (tp, tr)),
            ("completion_times", (jp, jr, 2.5), (tp, tr, 2.5))):
        want = np.asarray(getattr(j_latency, fn)(*args_j))
        got = getattr(latency, fn)(*args_t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=fn)
    want_u = np.asarray(j_latency.per_user_latency(jp, jr, tcomp=t_eff))
    got_u = latency.per_user_latency(tp, tr, tcomp=T(t_eff)).numpy()
    np.testing.assert_allclose(got_u, want_u, rtol=1e-6)
    want_c = np.asarray(j_latency.completion_times(jp, jr, 1.0, tcomp=t_eff))
    np.testing.assert_allclose(
        latency.completion_times(tp, tr, 1.0, tcomp=T(t_eff)).numpy(),
        want_c, rtol=1e-6)
    assert np.isinf(want_c[~selected]).all()
    for deadline in (math.inf, 1.5, float(np.median(want_u))):
        np.testing.assert_array_equal(
            latency.on_time(T(np.array(want_u)), deadline).numpy(),
            np.asarray(j_latency.on_time(want_u, deadline)))
        np.testing.assert_allclose(
            latency.deadline_round_latency(T(np.array(want_u)), T(selected),
                                           deadline).item(),
            float(j_latency.deadline_round_latency(want_u, selected,
                                                   deadline)), rtol=1e-6)
    for payload in (0.5, t_eff):
        np.testing.assert_allclose(
            latency.uplink_bits(T(selected), payload if np.isscalar(payload)
                                else T(payload)).item(),
            float(j_latency.uplink_bits(selected, payload)), rtol=1e-6)


def test_delivery_discounted_matches_jax():
    rs = np.random.default_rng(3)
    snr = rs.uniform(1.0, 1e3, (20, 4)).astype(np.float32)
    p = rs.uniform(-0.2, 1.2, 20).astype(np.float32)    # clipped to [0, 1]
    common = dict(tcomp=np.full(20, 0.1, np.float32),
                  bs_bw=np.ones(4, np.float32),
                  coeff=np.ones((20, 4), np.float32),
                  necessary=np.zeros(20, bool), min_participants=10)
    want = j_sched.delivery_discounted(JProblem(snr=snr, p_deliver=p,
                                                **common))
    tp = TProblem(snr=T(snr), p_deliver=T(p),
                  **{k: T(v) if isinstance(v, np.ndarray) else v
                     for k, v in common.items()})
    got = t_sched.delivery_discounted(tp)
    np.testing.assert_array_equal(got.snr.numpy(), np.asarray(want.snr))
    assert got.coeff is tp.coeff
    tp.p_deliver = None
    assert t_sched.delivery_discounted(tp) is tp


# --------------------------------------------------------- engine runs --
@pytest.mark.parametrize("extra, mode", [
    (dict(scheduler="dagsa-r", faults="faulty-uplink"), None),
    (dict(scheduler="dagsa-r-host", faults="faulty-uplink"), "eager"),
    (dict(scheduler="dagsa_jit", faults="straggler-heavy"), None),
    (dict(scheduler="dagsa_jit", faults="faulty-uplink",
          aggregation="hierarchical", tau_global=2), None),
    (dict(scheduler="rs", faults=faults.FaultSpec(**ALL_ON)), None),
], ids=["engine_faulty", "dagsa-r-host_eager", "straggler-heavy",
        "hier_faulty", "rs_all_faults"])
def test_faulty_engine_matches_live_jax_run(extra, mode):
    """``engine_faulty`` is the golden case; the host twin runs against
    JAX's eager path (the only one that runs it)."""
    if isinstance(extra.get("faults"), faults.FaultSpec):
        jextra = dict(extra, faults=j_faults.FaultSpec(**ALL_ON))
        sim, recs = _run_with_jax_spec(extra, jextra)
    else:
        sim, recs = check_run_against_live_jax(extra, mode=mode)
    assert all(0 <= r.n_delivered <= r.n_selected for r in recs)
    assert sum(r.n_selected - r.n_delivered for r in recs) > 0


def _run_with_jax_spec(extra, jextra):
    """check_run_against_live_jax with a FaultSpec object on each side."""
    import tests.test_torch_slice as slice_tests
    real = slice_tests.JConfig

    def jconfig(**kw):
        kw["faults"] = jextra["faults"]
        return real(**kw)

    slice_tests.JConfig = jconfig
    try:
        return check_run_against_live_jax(extra)
    finally:
        slice_tests.JConfig = real


def test_adversarial_updates_run_matches_jax_and_stays_finite():
    """NaN poisoning (15% of updates) with the clip_norm=25 defense, 3
    rounds.  Records match at every round and the model stays finite.
    The parameters match after 2 rounds; in round 3 one client's local
    SGD meets a max-pool near-tie (two conv2 outputs 2.2e-6 apart whose
    order the packages' float32 sums flip, ROADMAP C.8), so its gradient
    routes to another cell and the conv leaves move apart by ~1e-3; the
    dense layers, which the routing does not reach, still match."""
    extra = dict(scheduler="dagsa-r", faults="adversarial-updates")
    sim, recs = check_run_against_live_jax(extra, layers=("fc1", "fc2"),
                                           prefix=2)
    for k, sub in params_to_numpy(sim.params).items():
        for leaf, v in sub.items():
            assert np.isfinite(v).all(), f"{k}.{leaf}"
    assert sim.faults.clip_norm == 25.0
