"""DAGSA decisions: repro_torch.core.dagsa_jit against repro.core.dagsa_jit,
and the host greedy repro_torch.core.dagsa against repro.core.dagsa.

The same numpy-made SchedulingProblem and the same PRNG key (host greedy:
the same numpy seed) go through both packages.  ``assign`` and
``selected`` must match exactly; ``bw``,
``bs_time`` and ``t_round`` within rtol=1e-5 (Eq. (11) sums in another
order).  A decision can only flip where a feasibility test
``t_with <= t_star`` is within an ulp of a tie; the check is exact, so such a
flip would fail here, with the margin in the message.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import dagsa as j_host  # noqa: E402
from repro.core import dagsa_jit as j_dagsa  # noqa: E402
from repro.core.types import SchedulingProblem as JProblem  # noqa: E402
from repro_torch.core import bandwidth  # noqa: E402
from repro_torch.core import dagsa as t_host  # noqa: E402
from repro_torch.core import dagsa_jit as t_dagsa  # noqa: E402
from repro_torch.core.scheduler import schedule  # noqa: E402
from repro_torch.core.types import SchedulingProblem as TProblem  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.interop import key_from_numpy  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()


def _problem(seed, n, m):
    """A paper-like round: path-loss-spread Rayleigh SNR, S = 0.5 Mbit."""
    rs = np.random.default_rng(seed)
    mean = 10.0 ** rs.uniform(0.0, 4.0, (n, m))
    snr = (mean * rs.exponential(size=(n, m))).astype(np.float32)
    coeff = (np.float32(0.5) / np.maximum(np.log2(1.0 + snr), 1e-9)
             ).astype(np.float32)
    tcomp = rs.uniform(0.10, 0.11, n).astype(np.float32)
    bs_bw = (np.ones(m) if seed % 2 else rs.uniform(0.5, 1.5, m)
             ).astype(np.float32)
    necessary = rs.random(n) < (0.0 if seed % 5 == 0 else 0.2)
    return snr, coeff, tcomp, bs_bw, necessary, int(math.ceil(0.5 * n))


@pytest.mark.parametrize("n,m", [(12, 4), (50, 8), (30, 1), (40, 5)])
def test_dagsa_decisions_match_jax(n, m):
    for seed in range(20):
        snr, coeff, tcomp, bs_bw, nec, k_min = _problem(seed, n, m)
        with jax.threefry_partitionable(True):
            jkey = jax.random.PRNGKey(seed)
            want = j_dagsa.dagsa_schedule_jit(
                JProblem(snr=snr, tcomp=tcomp, bs_bw=bs_bw, coeff=coeff,
                         necessary=nec, min_participants=k_min), jkey)
        got = t_dagsa.dagsa_schedule_jit(
            TProblem(snr=torch.from_numpy(snr), tcomp=torch.from_numpy(tcomp),
                     bs_bw=torch.from_numpy(bs_bw),
                     coeff=torch.from_numpy(coeff),
                     necessary=torch.from_numpy(nec), min_participants=k_min),
            key_from_numpy(np.asarray(jkey)))
        w_assign = np.asarray(want.assign)
        g_assign = got.assign.numpy()
        if not np.array_equal(w_assign, g_assign):
            t_k = np.asarray(want.bs_time)
            pytest.fail(f"seed {seed} (N={n}, M={m}): assignment differs; "
                        f"jax bs_time {t_k}, port {got.bs_time.numpy()}, "
                        f"margin {np.abs(t_k - got.bs_time.numpy()).max():.3e}")
        np.testing.assert_array_equal(got.selected.numpy(),
                                      np.asarray(want.selected))
        assert got.selected.sum().item() >= k_min
        np.testing.assert_allclose(got.bw.numpy(), np.asarray(want.bw),
                                   rtol=1e-5)
        np.testing.assert_allclose(got.bs_time.numpy(),
                                   np.asarray(want.bs_time), rtol=1e-5)
        np.testing.assert_allclose(got.t_round.item(), float(want.t_round),
                                   rtol=1e-5)


def _t_problem(snr, coeff, tcomp, bs_bw, nec, k_min):
    return TProblem(snr=torch.from_numpy(snr), tcomp=torch.from_numpy(tcomp),
                    bs_bw=torch.from_numpy(bs_bw),
                    coeff=torch.from_numpy(coeff),
                    necessary=torch.from_numpy(nec), min_participants=k_min)


@pytest.mark.parametrize("n,m", [(12, 4), (50, 8), (30, 1), (40, 5)])
def test_host_dagsa_decisions_match_jax(n, m):
    """The host greedy, 20 problems a shape (80 in all, M = 1 included):
    ``assign`` and ``selected`` exact, ``bs_time`` and ``t_round`` within
    rtol=1e-5 (the final Eq. (11) solve is float32 in both)."""
    for seed in range(20):
        arrays = _problem(seed, n, m)
        snr, coeff, tcomp, bs_bw, nec, k_min = arrays
        want = j_host.dagsa_schedule(
            JProblem(snr=snr, tcomp=tcomp, bs_bw=bs_bw, coeff=coeff,
                     necessary=nec, min_participants=k_min), seed=seed)
        got = t_host.dagsa_schedule(_t_problem(*arrays), seed=seed)
        np.testing.assert_array_equal(got.assign.numpy(),
                                      np.asarray(want.assign),
                                      err_msg=f"seed {seed} (N={n}, M={m})")
        np.testing.assert_array_equal(got.selected.numpy(),
                                      np.asarray(want.selected))
        assert got.selected.sum().item() >= min(k_min, n)
        np.testing.assert_allclose(got.bs_time.numpy(),
                                   np.asarray(want.bs_time), rtol=1e-5)
        np.testing.assert_allclose(got.t_round.item(), float(want.t_round),
                                   rtol=1e-5)
        np.testing.assert_allclose(got.bw.numpy(), np.asarray(want.bw),
                                   rtol=1e-5)


def test_host_dagsa_is_seed_deterministic():
    """One numpy generator is the only entropy: the same seed gives the
    same schedule, and the numpy mirror of Eq. (11) is the JAX one."""
    arrays = _problem(7, 40, 5)
    a = t_host.dagsa_schedule(_t_problem(*arrays), seed=3)
    b = t_host.dagsa_schedule(_t_problem(*arrays), seed=3)
    assert torch.equal(a.assign, b.assign)
    snr, coeff, tcomp, bs_bw, nec, _ = arrays
    mask = np.random.default_rng(1).random(40) < 0.5
    for method in ("newton", "bisect"):
        assert t_host._bs_time_np(coeff[:, 0].astype(np.float64),
                                  tcomp.astype(np.float64), mask,
                                  float(bs_bw[0]), method=method) == \
            j_host._bs_time_np(coeff[:, 0].astype(np.float64),
                               tcomp.astype(np.float64), mask,
                               float(bs_bw[0]), method=method)
    with pytest.raises(ValueError):
        t_host._bs_time_np(coeff[:, 0], tcomp, mask, 1.0, method="secant")


def test_registry_routes_and_rejects_later_schedulers():
    snr, coeff, tcomp, bs_bw, nec, k_min = _problem(1, 12, 4)
    prob = TProblem(snr=torch.from_numpy(snr), tcomp=torch.from_numpy(tcomp),
                    bs_bw=torch.from_numpy(bs_bw), coeff=torch.from_numpy(coeff),
                    necessary=torch.from_numpy(nec), min_participants=k_min)
    key = torch.tensor([0, 1])
    res = schedule("dagsa_jit", prob, WirelessConfig(n_users=12, n_bs=4), key)
    direct = t_dagsa.dagsa_schedule_jit(prob, key)
    assert torch.equal(res.assign, direct.assign)
    res = schedule("dagsa", prob, WirelessConfig(n_users=12, n_bs=4), key,
                   seed=5)
    direct = t_host.dagsa_schedule(prob, seed=5)
    assert torch.equal(res.assign, direct.assign)
    assert torch.equal(res.bs_time, direct.bs_time)
    # a stateful policy from the registry is its round 0 from fresh state
    from repro_torch.core.scheduler import (schedule_stateful,
                                            scheduler_state_init)
    w = WirelessConfig(n_users=12, n_bs=4)
    res = schedule("ucb", prob, w, key)
    direct, _ = schedule_stateful("ucb", prob, w, key,
                                  scheduler_state_init("ucb", 12))
    assert torch.equal(res.assign, direct.assign)
    with pytest.raises(ValueError, match="unknown"):
        schedule("nope", prob, w, key)


def test_solve_all_satisfies_eq11_and_eq12():
    """Eq. (12) bandwidths exhaust each BS budget and finish together."""
    snr, coeff, tcomp, bs_bw, _, _ = _problem(3, 20, 4)
    rs = np.random.default_rng(3)
    bs_of = rs.integers(0, 4, 20)
    assign = np.zeros((20, 4), bool)
    assign[np.arange(20), bs_of] = True
    assign[:, 3] = False                          # an empty BS
    t_k, user_bw = bandwidth.solve_all(torch.from_numpy(coeff),
                                       torch.from_numpy(tcomp),
                                       torch.from_numpy(assign),
                                       torch.from_numpy(bs_bw))
    t_k, user_bw = t_k.numpy(), user_bw.numpy()
    assert t_k[3] == 0.0
    for k in range(3):
        on = assign[:, k]
        np.testing.assert_allclose(user_bw[on].sum(), bs_bw[k], rtol=1e-4)
        np.testing.assert_allclose(tcomp[on] + coeff[on, k] / user_bw[on],
                                   t_k[k], rtol=1e-4)
    assert (user_bw[~assign.any(axis=1)] == 0).all()


@pytest.mark.parametrize("method", ["newton", "bisect"])
def test_bs_time_and_allocate_match_jax(method):
    from repro.core import bandwidth as j_bandwidth
    snr, coeff, tcomp, bs_bw, _, _ = _problem(4, 30, 2)
    mask = np.random.default_rng(4).random(30) < 0.5
    c, b = coeff[:, 0], bs_bw[0]
    for hint in (None, np.float32(0.2)):
        want = float(j_bandwidth.bs_time(c, tcomp, mask, b, method=method,
                                         lo_hint=hint))
        got = bandwidth.bs_time(
            torch.from_numpy(c), torch.from_numpy(tcomp),
            torch.from_numpy(mask), torch.tensor(b), method=method,
            lo_hint=None if hint is None else torch.tensor(hint))
        np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    t_w, bi_w = j_bandwidth.allocate(c, tcomp, mask, b, method=method)
    t_g, bi_g = bandwidth.allocate(torch.from_numpy(c),
                                   torch.from_numpy(tcomp),
                                   torch.from_numpy(mask), torch.tensor(b),
                                   method=method)
    np.testing.assert_allclose(t_g.item(), float(t_w), rtol=1e-5)
    np.testing.assert_allclose(bi_g.numpy(), np.asarray(bi_w), rtol=1e-5)
    assert bandwidth.default_iters(method) == j_bandwidth.default_iters(method)
    with pytest.raises(ValueError):
        bandwidth.default_iters("secant")
