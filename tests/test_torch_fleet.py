"""The fleet axis: the batched DAGSA greedy, ``schedule_batch``, the
fleet-axis plain versions of kernels 1-3 and key-batch PRNG draws in the
port, against the JAX package and against the port's per-problem calls.

``dagsa_schedule_batch`` and ``schedule_batch`` take numpy-made problems
and keys ``split(PRNGKey(seed), F)`` in both packages: ``assign`` and
``selected`` exact, ``bw``, ``bs_time`` and ``t_round`` within rtol=1e-5
(Eq. (11) sums in another order).  The batch against the port's own
per-problem greedy, the plain fleet kernels against F 2-D plain calls,
and the key-batch draws against F single-key draws: bit for bit.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as j_channel  # noqa: E402
from repro.core import dagsa_jit as j_dagsa  # noqa: E402
from repro.core import scheduler as j_sched  # noqa: E402
from repro.core.types import SchedulingProblem as JProblem  # noqa: E402
from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.core import dagsa_jit as t_dagsa  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core.types import SchedulingProblem as TProblem  # noqa: E402
from repro_torch.interop import key_from_numpy  # noqa: E402
from repro_torch.kernels import bandwidth_solve as kb  # noqa: E402
from repro_torch.kernels import select_topk as ks  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy
FIELDS = ("snr", "tcomp", "bs_bw", "coeff", "necessary")
ARGS = ("snr", "coeff", "tcomp", "bs_bw", "necessary")   # _schedule's order


def _problem(seed, n, m, nec_frac=0.2):
    """A paper-like round (S = 0.5 Mbit, tcomp ~ U[0.10, 0.11]) with a
    delivery estimate in [0.3, 1] (dagsa-r's input)."""
    rs = np.random.default_rng(seed)
    mean = 10.0 ** rs.uniform(0.0, 4.0, (n, m))
    snr = (mean * rs.exponential(size=(n, m))).astype(np.float32)
    coeff = (np.float32(0.5) / np.maximum(np.log2(1.0 + snr), 1e-9)
             ).astype(np.float32)
    tcomp = rs.uniform(0.10, 0.11, n).astype(np.float32)
    bs_bw = (np.ones(m) if seed % 2 else rs.uniform(0.5, 1.5, m)
             ).astype(np.float32)
    necessary = rs.random(n) < (0.0 if seed % 5 == 0 else nec_frac)
    p_deliver = rs.uniform(0.3, 1.0, n).astype(np.float32)
    return dict(snr=snr, tcomp=tcomp, bs_bw=bs_bw, coeff=coeff,
                necessary=necessary, p_deliver=p_deliver)


def _fleet(seeds, n, m):
    """{field: [F, ...] numpy} for the problems of ``seeds``."""
    ps = [_problem(s, n, m) for s in seeds]
    return {k: np.stack([p[k] for p in ps]) for k in ps[0]}


def _keys(seed, f):
    with jax.threefry_partitionable(True):
        jkeys = jax.random.split(jax.random.PRNGKey(seed), f)
    return jkeys, key_from_numpy(np.asarray(jkeys))


def _assert_fleet(got, want, what):
    assign, selected, bw, bs_time, t_round = (
        np.asarray(getattr(want, k)) for k in ("assign", "selected", "bw",
                                               "bs_time", "t_round"))
    for f in range(assign.shape[0]):
        if not np.array_equal(got.assign[f].numpy(), assign[f]):
            pytest.fail(f"{what} problem {f}: assignment differs; jax "
                        f"bs_time {bs_time[f]}, port "
                        f"{got.bs_time[f].numpy()}")
    np.testing.assert_array_equal(got.selected.numpy(), selected,
                                  err_msg=what)
    np.testing.assert_allclose(got.bw.numpy(), bw, rtol=1e-5, err_msg=what)
    np.testing.assert_allclose(got.bs_time.numpy(), bs_time, rtol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(got.t_round.numpy(), t_round, rtol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("n,m", [(12, 4), (50, 8)])
def test_dagsa_schedule_batch_matches_jax(n, m):
    """20 problems a fleet; the batch against the port's per-problem
    greedy too, bit for bit."""
    arrays = _fleet(range(20), n, m)
    k_min = int(math.ceil(0.5 * n))
    jkeys, tkeys = _keys(n, 20)
    with jax.threefry_partitionable(True):
        want = j_dagsa.dagsa_schedule_batch(
            JProblem(**{k: arrays[k] for k in FIELDS},
                     min_participants=k_min), jkeys)
    got = t_dagsa.dagsa_schedule_batch(
        TProblem(**{k: T(arrays[k]) for k in FIELDS},
                 min_participants=k_min), tkeys)
    _assert_fleet(got, want, f"N={n}, M={m}")
    for f in range(20):
        one = t_dagsa._schedule(*(T(arrays[k][f]) for k in ARGS), k_min,
                                tkeys[f])
        for a, b in zip(one, (got.assign[f], got.selected[f], got.bw[f],
                              got.bs_time[f], got.t_round[f])):
            assert torch.equal(a, b), f


class _SplitSpy:
    """``repro_torch.rng`` with every ``split`` the greedy makes recorded:
    the fleet's keys at each greedy step."""

    def __init__(self):
        self.keys = []

    def __getattr__(self, name):
        return getattr(rng, name)

    def split(self, key, num=2):
        self.keys.append(key.clone())
        return rng.split(key, num)


def test_finished_problems_freeze_their_state_and_keys(monkeypatch):
    """A fleet whose problems stop at different steps, one of them at
    step 0 (every user necessary: nothing remains).  Each problem's
    decisions equal its own greedy's, and each key advances only while its
    problem runs: from its last step on it stays as that step left it."""
    n, m, k_min = 20, 4, 10
    arrays = [_problem(s, n, m, nec_frac=frac)
              for s, frac in ((1, 0.0), (2, 0.3), (3, 0.6), (4, 1.0))]
    arrays[3]["necessary"][:] = True
    fleet = {k: np.stack([a[k] for a in arrays]) for k in FIELDS}
    _, keys = _keys(3, 4)
    spy = _SplitSpy()
    monkeypatch.setattr(t_dagsa, "rng", spy)
    got = t_dagsa._schedule_batch(*(T(fleet[k]) for k in ARGS), k_min,
                                  keys)
    batch_keys = torch.stack(spy.keys)                       # [S, F, 2]
    steps = []
    for f in range(4):
        spy.keys.clear()
        one = t_dagsa._schedule(*(T(fleet[k][f]) for k in ARGS), k_min,
                                keys[f])
        for a, b in zip(one, got):
            assert torch.equal(a, b[f]), f
        s_f = len(spy.keys)
        steps.append(s_f)
        own = [k[0] for k in spy.keys]              # the fleet of one's key
        if s_f:
            assert torch.equal(batch_keys[:s_f, f], torch.stack(own))
        frozen = keys[f] if s_f == 0 else rng.split(own[-1])[0]
        assert (batch_keys[s_f:, f] == frozen).all(), f
    assert steps[3] == 0 and len(set(steps)) == 4
    assert batch_keys.shape[0] == max(steps)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_dagsa_schedule_batch_compact_planes_match_jax(dtype):
    """The greedy on bf16 planes and on int8 dB codes with [F, M] scales,
    as the sweeps store them (Eq. (11) from the float32 coefficients)."""
    n, m, k_min = 30, 5, 15
    arrays = _fleet(range(8), n, m)
    with jax.threefry_partitionable(True):
        if dtype == "int8":
            q, scale = jax.vmap(j_channel.quantize_snr_int8)(arrays["snr"])
            lin = jax.vmap(j_channel.dequantize_snr_int8)(q, scale)
            coeff = np.asarray(jax.vmap(
                lambda s: j_channel.bandwidth_time_coeff(s, JWireless()))(lin))
            plane, scale = np.asarray(q), np.asarray(scale)
        else:
            plane = jnp.asarray(arrays["snr"], jnp.bfloat16)
            coeff, scale = arrays["coeff"], None
        jkeys, tkeys = _keys(5, 8)
        want = j_dagsa.dagsa_schedule_batch(
            JProblem(snr=plane, tcomp=arrays["tcomp"], bs_bw=arrays["bs_bw"],
                     coeff=coeff, necessary=arrays["necessary"],
                     min_participants=k_min), jkeys, snr_scale=scale)
    t_plane = (T(plane) if dtype == "int8" else
               T(np.array(plane.astype(jnp.float32))).to(torch.bfloat16))
    got = t_dagsa.dagsa_schedule_batch(
        TProblem(snr=t_plane, tcomp=T(arrays["tcomp"]),
                 bs_bw=T(arrays["bs_bw"]), coeff=T(np.asarray(coeff)),
                 necessary=T(arrays["necessary"]), min_participants=k_min),
        tkeys, snr_scale=None if scale is None else T(scale))
    _assert_fleet(got, want, dtype)


def test_stack_problems_raises_as_jax_does():
    a = TProblem(**{k: T(v) for k, v in _problem(0, 12, 4).items()},
                 min_participants=6)
    b = TProblem(**{k: T(v) for k, v in _problem(1, 12, 4).items()},
                 min_participants=7)
    with pytest.raises(ValueError, match="min_participants must agree"):
        t_dagsa.stack_problems([a, b])
    c = TProblem(**{k: T(v) for k, v in _problem(2, 12, 4).items()
                    if k != "p_deliver"}, min_participants=6)
    with pytest.raises(ValueError, match="p_deliver must be set"):
        t_dagsa.stack_problems([a, c])
    s = t_dagsa.stack_problems([a, a])
    assert s.snr.shape == (2, 12, 4) and s.p_deliver.shape == (2, 12)


@pytest.mark.parametrize("name", t_sched.BATCH_SCHEDULERS)
def test_schedule_batch_matches_jax(name):
    """Every batch scheduler on 6 problems of 12 users x 4 BSs."""
    n, m, k_min = 12, 4, 6
    assert t_sched.BATCH_SCHEDULERS == j_sched.BATCH_SCHEDULERS
    ps = [_problem(s, n, m) for s in range(6)]
    jkeys, tkeys = _keys(11, 6)
    with jax.threefry_partitionable(True):
        want = j_sched.schedule_batch(
            name, [JProblem(**p, min_participants=k_min) for p in ps], jkeys)
    got = t_sched.schedule_batch(
        name, [TProblem(**{k: T(v) for k, v in p.items()},
                        min_participants=k_min) for p in ps], tkeys)
    _assert_fleet(got, want, name)


def test_schedule_batch_rejects_the_host_greedy():
    p = TProblem(**{k: T(v) for k, v in _problem(0, 12, 4).items()},
                 min_participants=6)
    with pytest.raises(ValueError, match="unknown batch scheduler"):
        t_sched.schedule_batch("dagsa", [p, p], torch.zeros((2, 2),
                                                            dtype=torch.long))
    with pytest.raises(TypeError, match="unexpected kwargs"):
        t_sched.schedule_batch("rs", [p, p], torch.zeros((2, 2),
                                                         dtype=torch.long),
                               iters=3)


# ------------------------------------------------ fleet-axis plain kernels --
def _planes(dtype, f, n, m, seed=0):
    """[F, N, M] planes of ``dtype`` with exact ties, and [F, M] scales
    for int8 (one negative)."""
    rs = np.random.default_rng(seed)
    x = rs.uniform(-50, 50, (f, n, m)).astype(np.float32)
    x[:, 3] = x[:, 1]                               # tied users
    x[:, :, m - 1] = x[:, :, 0]                     # tied BSs
    scale = None
    if dtype == "int8":
        snr = T(np.clip(np.round(x), -127, 127).astype(np.int8))
        sc = rs.uniform(0.05, 0.5, (f, m)).astype(np.float32)
        sc[0, 1] = -sc[0, 1]
        scale = T(sc)
    elif dtype == "bf16":
        snr = T(x).to(torch.bfloat16)
    else:
        snr = T(x)
    return snr, scale


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_fleet_plain_selection_equals_per_problem_calls(dtype):
    f, n, m = 5, 37, 6
    snr, scale = _planes(dtype, f, n, m)
    rem = T(np.random.default_rng(1).random((f, n)) < 0.6)
    rem[2] = False                                  # nothing remains
    cand, best = ks.masked_bs_argmax(snr, rem, scale)
    bb = ks.best_bs_argmax(snr, scale)
    assert cand.shape == best.shape == (f, m) and bb.shape == (f, n)
    for i in range(f):
        sc = None if scale is None else scale[i]
        c1, b1 = ks.masked_bs_argmax_plain(snr[i], rem[i], sc)
        assert torch.equal(cand[i], c1) and torch.equal(best[i], b1)
        assert torch.equal(bb[i], ks.best_bs_argmax_plain(snr[i], sc))
    assert (cand[2] == 0).all() and torch.isinf(best[2]).all()


@pytest.mark.parametrize("shared", [True, False])
def test_fleet_plain_bandwidth_solve_equals_per_problem_calls(shared):
    """Kernel 1 on [F, K, U] with tcomp [F, U] (a problem's rows share
    it) or [F, K, U], and a warm start, against F 2-D plain calls."""
    f, k, u = 4, 5, 40
    rs = np.random.default_rng(2)
    coeff = T(rs.uniform(0.01, 0.2, (f, k, u)).astype(np.float32))
    tc = rs.uniform(0.1, 0.11, (f, u) if shared else (f, k, u))
    tcomp = T(tc.astype(np.float32))
    mask = T(rs.random((f, k, u)) < 0.3)
    mask[1, 2] = False                              # an empty row
    bw = T(rs.uniform(0.5, 1.5, (f, k)).astype(np.float32))
    lo = T(rs.uniform(0.0, 0.2, (f, k)).astype(np.float32))
    for method in ("newton", "bisect"):
        got = kb.bandwidth_solve(coeff, tcomp, mask, bw, lo=lo,
                                 method=method)
        plain = kb.bandwidth_solve_fleet_plain(coeff, tcomp, mask, bw, lo=lo,
                                               method=method)
        assert got.shape == (f, k) and torch.equal(got, plain)
        for i in range(f):
            one = kb.bandwidth_solve_plain(coeff[i], tcomp[i], mask[i],
                                           bw[i], lo=lo[i], method=method)
            assert torch.equal(got[i], one), (method, i)
        assert got[1, 2] == 0.0
    # [G, U] rows shared by K / G consecutive rows of a 2-D call
    flat = kb.bandwidth_solve(coeff.reshape(f * k, u),
                              tcomp if shared else tcomp.reshape(f * k, u),
                              mask.reshape(f * k, u), bw.reshape(-1))
    assert torch.equal(flat.reshape(f, k),
                       kb.bandwidth_solve(coeff, tcomp, mask, bw))
    with pytest.raises(ValueError, match="do not divide"):
        kb.bandwidth_solve(coeff.reshape(f * k, u), tcomp[:3, :u]
                           if shared else tcomp[:3, 0],
                           mask.reshape(f * k, u), bw.reshape(-1))


# ------------------------------------------------------- key-batch draws --
def test_key_batch_draws_equal_single_key_draws():
    """split, randint, bernoulli and uniform over [F, 2] keys give what F
    single-key calls give, bit for bit (every draw vectorises over the
    leading key axes)."""
    keys = rng.split(rng.PRNGKey(42), 9)                    # [9, 2]
    batch = {"split": rng.split(keys, 3),
             "randint": rng.randint(keys, (), 0, 7),
             "randint_shape": rng.randint(keys, (5,), -3, 100),
             "bernoulli": rng.bernoulli(keys, 0.5, (12,)),
             "uniform": rng.uniform(keys, (4, 3), 0.25, 2.0)}
    for f in range(9):
        k = keys[f]
        single = {"split": rng.split(k, 3),
                  "randint": rng.randint(k, (), 0, 7),
                  "randint_shape": rng.randint(k, (5,), -3, 100),
                  "bernoulli": rng.bernoulli(k, 0.5, (12,)),
                  "uniform": rng.uniform(k, (4, 3), 0.25, 2.0)}
        for name, v in single.items():
            assert torch.equal(batch[name][f], v), (name, f)
    # and they are JAX's draws
    with jax.threefry_partitionable(True):
        jk = jax.random.split(jax.random.PRNGKey(42), 9)
        want = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (), 0, 7))(jk))
    np.testing.assert_array_equal(batch["randint"].numpy(), want)
