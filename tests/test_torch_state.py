"""The stateful online schedulers (``ucb``, ``biased-adaptive``, ``rr``,
``pf``) in the port against the JAX package.

Each policy runs 5 rounds of numpy-made problems in both packages (JAX
under ``jax.jit``, as its round step runs it), each carrying its own
``SchedulerState``: the selections and assignments exact, the state
fields within rtol=1e-6 and the round times within rtol=1e-5.  Then each
policy's ``FLSimulation`` against a live JAX run (the step engine; JAX's
eager engine refuses stateful policies) and ``ucb`` learning sweeps
(float32 and bfloat16 planes) against JAX's.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import scheduler as j_sched  # noqa: E402
from repro.core.types import SchedulingProblem as JProblem  # noqa: E402
from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.launch import sweep as j_sweep  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core.types import SchedulingProblem as TProblem  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from test_torch_slice import check_run_against_live_jax  # noqa: E402
from test_torch_sweep import LEARN, _check_learning  # noqa: E402
from test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy
STATEFUL = ("ucb", "biased-adaptive", "rr", "pf")
STATE_FIELDS = ("n_obs", "rate_sum", "tcomp_sum", "sel_count", "ewma",
                "ptr", "t")


def _problem(seed, n, m):
    """A paper-like round; a few users Eq. (8g)-necessary after round 0."""
    rs = np.random.default_rng(seed)
    mean = 10.0 ** rs.uniform(0.0, 4.0, (n, m))
    snr = (mean * rs.exponential(size=(n, m))).astype(np.float32)
    coeff = (np.float32(0.5) / np.maximum(np.log2(1.0 + snr), 1e-9)
             ).astype(np.float32)
    tcomp = rs.uniform(0.10, 0.11, n).astype(np.float32)
    bs_bw = rs.uniform(0.5, 1.5, m).astype(np.float32)
    necessary = rs.random(n) < (0.0 if seed == 0 else 0.1)
    return dict(snr=snr, tcomp=tcomp, bs_bw=bs_bw, coeff=coeff,
                necessary=necessary)


@pytest.mark.parametrize("name", STATEFUL)
def test_stateful_policy_matches_jax_over_rounds(name):
    n, m, rounds = 30, 5, 5
    k_min = int(math.ceil(0.3 * n))
    jcfg, tcfg = JWireless(n_users=n, n_bs=m), WirelessConfig(n_users=n,
                                                              n_bs=m)

    @jax.jit
    def j_round(arrays, state):
        prob = JProblem(**arrays, min_participants=k_min)
        res, state = j_sched.schedule_stateful(name, prob, jcfg,
                                               jax.random.PRNGKey(0), state)
        return res.assign, res.selected, res.t_round, state

    j_state = j_sched.scheduler_state_init(name, n)
    t_state = t_sched.scheduler_state_init(name, n)
    for r in range(rounds):
        arrays = _problem(r, n, m)
        j_assign, j_sel, j_t, j_state = j_round(arrays, j_state)
        res, t_state = t_sched.schedule_stateful(
            name, TProblem(**{k: T(v) for k, v in arrays.items()},
                           min_participants=k_min), tcfg,
            torch.zeros(2, dtype=torch.int64), t_state)
        np.testing.assert_array_equal(res.selected.numpy(), np.asarray(j_sel),
                                      err_msg=f"{name} round {r}")
        np.testing.assert_array_equal(res.assign.numpy(),
                                      np.asarray(j_assign))
        np.testing.assert_allclose(res.t_round.item(), float(j_t), rtol=1e-5)
        for f in STATE_FIELDS:
            np.testing.assert_allclose(
                getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f)),
                rtol=1e-6, err_msg=f"{name} round {r} {f}")
        assert t_state.ptr.dtype == torch.int32


@pytest.mark.parametrize("name", STATEFUL)
def test_one_shot_schedule_is_round_zero(name):
    """The registry's ``schedule`` runs a policy from fresh state: it
    equals ``schedule_stateful`` on ``scheduler_state_init`` and JAX's
    one-shot ``schedule``."""
    n, m = 20, 4
    arrays = _problem(3, n, m)
    cfg = WirelessConfig(n_users=n, n_bs=m)
    prob = TProblem(**{k: T(v) for k, v in arrays.items()},
                    min_participants=10)
    key = torch.tensor([0, 5])
    one = t_sched.schedule(name, prob, cfg, key)
    res, state = t_sched.schedule_stateful(
        name, prob, cfg, key, t_sched.scheduler_state_init(name, n))
    for f in ("assign", "selected", "bw", "bs_time", "t_round"):
        assert torch.equal(getattr(one, f), getattr(res, f)), f
    assert float(state.t) == 1.0
    want = j_sched.schedule(name, JProblem(**arrays, min_participants=10),
                            JWireless(n_users=n, n_bs=m),
                            jax.random.PRNGKey(5))
    np.testing.assert_array_equal(one.assign.numpy(), np.asarray(want.assign))
    assert t_sched.scheduler_state_init("dagsa_jit", n) is None


@pytest.mark.parametrize("name", STATEFUL)
def test_stateful_engine_matches_live_jax_run(name):
    """Three rounds of the engine world at 12 users x 4 BSs, the policy's
    estimates carried in RoundState.sched."""
    sim, _ = check_run_against_live_jax(dict(scheduler=name), mode="step")
    assert float(sim._state.sched.t) == 3.0


@pytest.mark.parametrize("scheduler,dtype", [("ucb", "f32"), ("ucb", "bf16"),
                                             ("rs", "bf16")])
def test_ucb_learning_sweep_matches_live_jax(scheduler, dtype):
    """The learning sweep under ``ucb``; on the bf16 plane the registry
    schedulers' Eq. (11) solves read the float32 quotient, as XLA's
    jitted sweep does (ROADMAP C.10; ``rs`` read the bf16 rounding before
    and its clock was 5e-4 off)."""
    kw = dict(LEARN, n_seeds=2, n_rounds=2, scheduler=scheduler,
              channel_dtype=dtype)
    with jax.threefry_partitionable(True):
        want = j_sweep.run_learning_sweep(
            ["paper-default"], cfg=JWireless(n_users=12, n_bs=4), **kw)
    got = sweep.run_learning_sweep(
        ["paper-default"], cfg=WirelessConfig(n_users=12, n_bs=4),
        device="cpu", **kw)
    _check_learning(want, got)
    assert got[0]["scheduler"] == scheduler
