"""The paper's baseline schedulers in the port against the JAX package:
``rs``, ``ub``, ``sa``, ``fedcs_low``, ``fedcs_high`` and the
delivery-discounted ``dagsa-r``, the even-split ``uniform_time``, the
brute-force optimum, and the ``engine_fedcs`` slice against a live run.

The same numpy-made problems and PRNG keys go through both registries'
``schedule``.  Each scheduler sees 44 problems (11 seeds x 4 shapes, M = 1
included) with exact SNR ties (a duplicated user row, and a BS column
equal to BS 0's, so that BS is no user's best BS and has no candidate),
Eq. (8g)-necessary users on most seeds, and bandwidths uniform or drawn.
``assign``, ``selected`` and ``n_selected`` must match exactly; ``bw``,
``bs_time`` and ``t_round`` within rtol=1e-5.  The JAX side runs under
``jax.jit``, as its round engine runs it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import bandwidth as j_bandwidth  # noqa: E402
from repro.core import bruteforce as j_brute  # noqa: E402
from repro.core import scheduler as j_sched  # noqa: E402
from repro.core.types import SchedulingProblem as JProblem  # noqa: E402
from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro_torch.core import bandwidth, bruteforce  # noqa: E402
from repro_torch.core import dagsa as t_host  # noqa: E402
from repro_torch.core import dagsa_jit as t_dagsa  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core.types import SchedulingProblem as TProblem  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.interop import key_from_numpy  # noqa: E402
from tests.test_torch_slice import check_run_against_live_jax  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy
SHAPES = [(12, 4), (50, 8), (30, 1), (40, 5)]
SEEDS = range(11)
BASELINES = ("rs", "ub", "sa", "fedcs_low", "fedcs_high", "dagsa-r")


def _problem(seed, n, m):
    """A paper-like round (S = 0.5 Mbit, tcomp ~ U[0.10, 0.11]) with exact
    ties, an SNR column that no user prefers (M > 1), necessary users on
    most seeds, and a delivery estimate in [0.3, 1] (dagsa-r's input)."""
    rs = np.random.default_rng(seed)
    mean = 10.0 ** rs.uniform(0.0, 4.0, (n, m))
    snr = (mean * rs.exponential(size=(n, m))).astype(np.float32)
    snr[n // 3] = snr[n // 5]                 # two users tie everywhere
    if m > 1:
        snr[:, m - 1] = snr[:, 0]             # ties go to BS 0: BS m-1 empty
    coeff = (np.float32(0.5) / np.maximum(np.log2(1.0 + snr), 1e-9)
             ).astype(np.float32)
    tcomp = rs.uniform(0.10, 0.11, n).astype(np.float32)
    tcomp[n // 3] = tcomp[n // 5]
    bs_bw = (np.ones(m) if seed % 2 else rs.uniform(0.5, 1.5, m)
             ).astype(np.float32)
    necessary = rs.random(n) < (0.0 if seed % 5 == 0 else 0.2)
    p_deliver = rs.uniform(0.3, 1.0, n).astype(np.float32)
    return dict(snr=snr, tcomp=tcomp, bs_bw=bs_bw, coeff=coeff,
                necessary=necessary, p_deliver=p_deliver,
                min_participants=int(math.ceil(0.5 * n)))


def _t_problem(arrays):
    return TProblem(**{k: (T(v) if isinstance(v, np.ndarray) else v)
                       for k, v in arrays.items()})


def _j_schedule(name, m, k_min):
    """JAX's registry ``schedule`` under jit, one compile per shape."""
    cfg = JWireless(n_users=12, n_bs=m)

    def run(snr, tcomp, bs_bw, coeff, necessary, p_deliver, key):
        prob = JProblem(snr=snr, tcomp=tcomp, bs_bw=bs_bw, coeff=coeff,
                        necessary=necessary, min_participants=k_min,
                        p_deliver=p_deliver)
        res = j_sched.schedule(name, prob, cfg, key)
        return res.assign, res.selected, res.bw, res.bs_time, res.t_round

    return run if name == "dagsa-r" else jax.jit(run)


def _assert_same_decisions(got, want, what):
    assign, selected, bw, bs_time, t_round = (np.asarray(a) for a in want)
    if not np.array_equal(got.assign.numpy(), assign):
        pytest.fail(f"{what}: assignment differs; jax bs_time {bs_time}, "
                    f"port {got.bs_time.numpy()}")
    np.testing.assert_array_equal(got.selected.numpy(), selected,
                                  err_msg=what)
    assert int(got.selected.sum()) == int(selected.sum())
    np.testing.assert_allclose(got.bw.numpy(), bw, rtol=1e-5, err_msg=what)
    np.testing.assert_allclose(got.bs_time.numpy(), bs_time, rtol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(got.t_round.item(), float(t_round),
                               rtol=1e-5, err_msg=what)


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_decisions_match_jax(name):
    n_problems = 0
    for n, m in SHAPES:
        k_min = int(math.ceil(0.5 * n))
        j_run = _j_schedule(name, m, k_min)
        for seed in SEEDS:
            arrays = _problem(seed, n, m)
            with jax.threefry_partitionable(True):
                jkey = jax.random.PRNGKey(seed)
                want = j_run(*(arrays[k] for k in (
                    "snr", "tcomp", "bs_bw", "coeff", "necessary",
                    "p_deliver")), jkey)
            got = t_sched.schedule(name, _t_problem(arrays),
                                   WirelessConfig(n_users=n, n_bs=m),
                                   key_from_numpy(np.asarray(jkey)))
            _assert_same_decisions(got, want, f"{name} seed {seed} "
                                              f"(N={n}, M={m})")
            if name in ("rs", "ub"):
                assert got.selected.numpy()[arrays["necessary"]].all()
            n_problems += 1
    assert n_problems >= 40


def test_fedcs_admits_by_snr_under_its_threshold():
    """Every BS's FedCS set is a prefix of its candidates in SNR order
    (a tie kept in user order) whose even-split time meets the threshold,
    and no user sits at a BS that is not its best."""
    for seed in SEEDS:
        arrays = _problem(seed, 40, 5)
        res = t_sched.schedule("fedcs_low", _t_problem(arrays),
                               WirelessConfig(n_users=40, n_bs=5),
                               torch.tensor([0, seed]))
        snr = arrays["snr"]
        best = snr.argmax(axis=1)
        assign = res.assign.numpy()
        assert not assign[:, 4].any()                  # the BS nobody prefers
        for k in range(5):
            cand = np.flatnonzero(best == k)
            order = cand[np.argsort(-snr[cand, k], kind="stable")]
            taken = np.flatnonzero(assign[:, k])
            assert sorted(order[:len(taken)]) == sorted(taken)
        assert float(res.t_round) <= t_sched.FEDCS_LOW_S + 1e-6


def test_uniform_time_matches_jax():
    for seed, (n, m) in enumerate(SHAPES):
        arrays = _problem(seed, n, m)
        rs = np.random.default_rng(seed)
        assign = rs.random((n, m)) < 0.4
        assign[:, 0] = False                            # an empty BS
        got = bandwidth.uniform_time(T(arrays["coeff"]), T(arrays["tcomp"]),
                                     T(assign), T(arrays["bs_bw"])).numpy()
        for k in range(m):
            want = float(j_bandwidth.uniform_time(
                arrays["coeff"][:, k], arrays["tcomp"], assign[:, k],
                arrays["bs_bw"][k]))
            one = bandwidth.uniform_time(
                T(arrays["coeff"][:, k].copy()), T(arrays["tcomp"]),
                T(assign[:, k].copy()), torch.tensor(arrays["bs_bw"][k]))
            np.testing.assert_allclose(got[k], want, rtol=1e-6)
            np.testing.assert_allclose(one.item(), want, rtol=1e-6)
        assert got[0] == 0.0


@pytest.mark.parametrize("n,m", [(4, 2), (5, 1), (6, 2)])
def test_bruteforce_matches_jax_and_bounds_dagsa(n, m):
    for seed in range(4):
        arrays = _problem(seed, n, m)
        arrays["min_participants"] = int(math.ceil(0.5 * n))
        jprob = JProblem(**{k: v for k, v in arrays.items()})
        t_want, a_want = j_brute.optimal_schedule(jprob)
        tprob = _t_problem(arrays)
        t_got, a_got = bruteforce.optimal_schedule(tprob)
        assert t_got == t_want
        np.testing.assert_array_equal(a_got, a_want)
        # DAGSA is a heuristic: never better than the exact optimum
        for res in (t_host.dagsa_schedule(tprob, seed=seed),
                    t_dagsa.dagsa_schedule_jit(tprob,
                                               torch.tensor([0, seed]))):
            assert float(res.t_round) >= t_got * (1 - 1e-5)
    with pytest.raises(ValueError, match="too large"):
        bruteforce.optimal_schedule(_t_problem(_problem(0, 12, 4)))


def test_engine_fedcs_matches_live_jax_run():
    """The ``engine_fedcs`` golden case: 12 users, 4 BSs, seed 7,
    ``fedcs_low``, 3 rounds, JAX's fused scan."""
    sim, recs = check_run_against_live_jax(dict(scheduler="fedcs_low"))
    assert all(r.n_delivered == -1 for r in recs)      # no fault layer
