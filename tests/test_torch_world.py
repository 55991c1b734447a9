"""The port's world models against the JAX package's, on the same inputs.

Mobility (every registered model), the shadowing field, the compact
channel planes, kernel 3's scaled inputs, the built-in scenarios, the
Dirichlet partition, and ``FLSimulation(FLConfig(scenario=s))`` for every
built-in scenario against a live JAX run.  Tolerances, each with its
reason:

* positions rtol 1e-5, atol 1e-4 m (the two packages' cos / sin / norm
  differ by an ulp); waypoint ``target`` and ``pause_s`` exact;
* the shadowing field rtol 1e-5 with atol 1e-4 dB: its 64 features'
  frequencies differ by an ulp of the normal draw (ROADMAP C.4), which a
  1 km position turns into ~1e-5 of a radian; a field value near zero has
  no relative precision;
* int8 codes and bf16 bits exact, scales rtol 1e-6, dequantised SNR rtol
  2e-6 (XLA's ``pow``);
* indices (kernel 3, the partition, ``categorical``) exact;
* engine runs as ``tests/test_torch_slice.py::check_run_against_live_jax``
  holds them (decisions exact, ``t_round`` rtol 1e-5, parameters rtol
  1e-4; the compressed uplink's parameters as test_torch_compress.py
  holds them).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as j_channel  # noqa: E402
from repro.core import mobility as j_mobility  # noqa: E402
from repro.core import scenario as j_scenario  # noqa: E402
from repro.core.types import MobilityState as JMobility  # noqa: E402
from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.fl import FLConfig as JConfig  # noqa: E402
from repro.fl.partition import dirichlet_partition as j_dirichlet  # noqa: E402
from repro.kernels import select_topk as j_select  # noqa: E402
from repro.launch import fl_sim as j_fl_sim  # noqa: E402
from repro_torch.core import channel, mobility, scenario  # noqa: E402
from repro_torch.core.types import MobilityState, WirelessConfig  # noqa: E402
from repro_torch.fl.partition import dirichlet_partition  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation  # noqa: E402
from repro_torch.interop import key_from_numpy  # noqa: E402
from repro_torch.kernels import select_topk as ks  # noqa: E402
from repro_torch.launch import fl_sim  # noqa: E402

from test_torch_compress import _flip_budget, assert_params_close  # noqa: E402
from test_torch_slice import (_parser_default,  # noqa: E402
                              check_run_against_live_jax)
from test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

BUILTINS = [s.name for s in scenario._BUILTINS]
W = WirelessConfig(n_users=40, n_bs=5)
JW = JWireless(n_users=40, n_bs=5)


def _key(seed):
    with jax.threefry_partitionable(True):
        jk = jax.random.PRNGKey(seed)
    return jk, key_from_numpy(np.asarray(jk))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------------- mobility --
def test_registry_order_and_ids_match_jax():
    assert list(mobility.MOBILITY_MODELS) == list(j_mobility.MOBILITY_MODELS)
    for name in mobility.MOBILITY_MODELS:
        assert mobility.model_index(name) == j_mobility.model_index(name)
    for mod in (mobility, j_mobility):
        with pytest.raises(ValueError, match="unknown mobility model"):
            mod.model_index("teleport")
        with pytest.raises(ValueError, match="already registered"):
            mod.register_mobility_model("rd", lambda *a: a)


@pytest.mark.parametrize("model", ["rd", "waypoint", "gauss_markov",
                                   "static"])
@pytest.mark.parametrize("speed,pause,gm", [(20.0, 2.0, 0.75),
                                            (100.0, 0.0, 0.0),
                                            (300.0, 1.0, 0.9)])
def test_mobility_models_three_rounds(model, speed, pause, gm):
    """Three rounds of each model through ``step_switch`` (the sweep's
    dispatch by registry id; JAX's under jit, every branch traced) and
    ``step_named`` (the engine's), from the same aux state; large speeds
    bounce off the walls and make waypoint users arrive and pause."""
    jk, tk = _key(int(speed + 10 * pause))
    with jax.threefry_partitionable(True):
        k0, ka, kr = jax.random.split(jk, 3)
        pos = jax.random.uniform(k0, (40, 2), maxval=1000.0)
        aux = j_mobility.init_aux(ka, 40, JW, speed_mps=speed)
        keys = jax.random.split(kr, 3)
        mid = j_mobility.model_index(model)
        sw = jax.jit(lambda k, p, a: j_mobility.step_switch(
            mid, k, p, a, 1000.0, 1.0, jnp.float32(speed),
            jnp.float32(pause), jnp.float32(gm)))
        want = []
        jp, ja = pos, aux
        for r in range(3):
            jp, ja = sw(keys[r], jp, ja)
            want.append((np.asarray(jp), _np(ja)))
        named = j_mobility.step_named(model, keys[0], pos, aux, JW,
                                      speed_mps=speed, pause_s=pause,
                                      gm_memory=gm)
    tp = torch.tensor(np.asarray(pos))
    ta = {k: torch.tensor(np.asarray(v)) for k, v in aux.items()}
    tkeys = key_from_numpy(np.asarray(keys))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    for r in range(3):
        tp, ta = mobility.step_switch(mid, tkeys[r], tp, ta, 1000.0, 1.0,
                                      f32(speed), f32(pause), f32(gm))
        wp, wa = want[r]
        np.testing.assert_allclose(tp.numpy(), wp, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(ta["vel"].numpy(), wa["vel"], rtol=1e-5,
                                   atol=1e-4)
        assert np.array_equal(ta["target"].numpy(), wa["target"])
        assert np.array_equal(ta["pause_s"].numpy(), wa["pause_s"])
    np_, na = mobility.step_named(
        model, tkeys[0], torch.tensor(np.asarray(pos)),
        {k: torch.tensor(np.asarray(v)) for k, v in aux.items()}, W,
        speed_mps=speed, pause_s=pause, gm_memory=gm)
    np.testing.assert_allclose(np_.numpy(), np.asarray(named[0]), rtol=1e-5,
                               atol=1e-4)
    assert np.array_equal(na["pause_s"].numpy(),
                          np.asarray(named[1]["pause_s"]))
    if model == "waypoint" and speed >= 100.0:       # arrivals happened
        assert not np.array_equal(ta["target"].numpy(),
                                  np.asarray(aux["target"]))
        if pause > 0.0:
            assert bool((ta["pause_s"] > 0).any())


def test_legacy_step_and_trajectory():
    jk, tk = _key(5)
    with jax.threefry_partitionable(True):
        st = j_mobility.init_positions(jk, JW)
        traj = np.asarray(j_mobility.trajectory(jk, st, JW, 4))
        one = np.asarray(j_mobility.step(jk, st, JW, speed_mps=55.0).user_pos)
    ts = mobility.init_positions(tk, W)
    assert np.array_equal(ts.user_pos.numpy(), np.asarray(st.user_pos))
    np.testing.assert_allclose(mobility.trajectory(tk, ts, W, 4).numpy(),
                               traj, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        mobility.step(tk, ts, W, speed_mps=55.0).user_pos.numpy(), one,
        rtol=1e-5, atol=1e-4)


# -------------------------------------------------------------- channel --
@pytest.mark.parametrize("sigma", [0.0, 8.0])
def test_shadowing_and_dist_and_shadow(sigma):
    jk, tk = _key(9)
    rs = np.random.default_rng(1)
    pos = rs.uniform(0, 1000, (300, 2)).astype(np.float32)
    bs = rs.uniform(0, 1000, (7, 2)).astype(np.float32)
    with jax.threefry_partitionable(True):
        field = np.asarray(jax.jit(lambda p, b: j_channel.sample_shadowing(
            jk, p, b, JW, sigma_db=8.0))(pos, bs))
        d, sh = jax.jit(lambda p, b: j_channel.dist_and_shadow(
            p, b, jnp.float32(sigma), jk, JW, None))(pos, bs)
    tpos, tbs = torch.tensor(pos), torch.tensor(bs)
    np.testing.assert_allclose(
        channel.sample_shadowing(tk, tpos, tbs, W, sigma_db=8.0).numpy(),
        field, rtol=1e-5, atol=1e-4)
    td, tsh = channel.dist_and_shadow(tpos, tbs, sigma, tk, W)
    np.testing.assert_allclose(td.numpy(), np.asarray(d), rtol=1e-6)
    if sigma == 0.0:       # JAX's field is all zeros: the port skips it
        assert tsh is None and not np.asarray(sh).any()
    else:
        np.testing.assert_allclose(tsh.numpy(), np.asarray(sh), rtol=1e-5,
                                   atol=1e-4)
    # in user blocks (a partial last block): the same values bit for bit
    cd, csh = channel.dist_and_shadow(tpos, tbs, sigma, tk, W, user_chunk=7)
    assert torch.equal(cd, td)
    assert (csh is None) == (tsh is None)
    if tsh is not None:
        assert torch.equal(csh, tsh)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_encode_channel_and_coefficients(dtype):
    """The channel plane and its Eq. (11) coefficients in each storage
    type: int8 codes and bf16 bits exact, scales rtol 1e-6; the bf16
    coefficients as jitted XLA rounds them (ROADMAP C.10)."""
    rs = np.random.default_rng(3)
    snr = (10 ** rs.uniform(-3, 5, (500, 9))).astype(np.float32)
    snr[0, 0] = 0.0                                   # the 1e-12 floor
    pay = rs.uniform(0.05, 1.0, 500).astype(np.float32)
    with jax.threefry_partitionable(True):
        st, sc, lin = jax.jit(lambda s: j_channel.encode_channel(s, dtype))(
            snr)
        src = lin if dtype == "int8" else st
        co = np.asarray(jax.jit(lambda s, p: j_channel.compress_channel(
            j_channel.bandwidth_time_coeff(s, JW, payload_mbit=p),
            dtype if dtype != "int8" else "f32"))(src, pay).astype(
                jnp.float32))
    ts, tsc, tlin = channel.encode_channel(torch.tensor(snr), dtype)
    if dtype == "bf16":
        assert ts.dtype == torch.bfloat16
        assert np.array_equal(ts.view(torch.int16).numpy(),
                              np.asarray(st).view(np.int16))
    else:
        assert np.array_equal(ts.numpy(), np.asarray(st))
    if dtype == "int8":
        np.testing.assert_allclose(tsc.numpy(), np.asarray(sc), rtol=1e-6)
        np.testing.assert_allclose(tlin.numpy(), np.asarray(lin), rtol=2e-6)
        np.testing.assert_allclose(
            channel.dequantize_snr_int8(torch.tensor(np.asarray(st)),
                                        torch.tensor(np.asarray(sc))).numpy(),
            np.asarray(lin), rtol=2e-6)
    else:
        assert tsc is None and tlin is ts
    # the int8 plane's coefficients from JAX's own dequantised plane: an
    # ulp of a small SNR moves f32(1 + snr), and so log2(1 + snr), by up to
    # 6e-8 / snr relative
    src_t = torch.tensor(np.asarray(lin)) if dtype == "int8" else ts
    coeff, loop = channel.plane_coefficients(ts, src_t, dtype, W,
                                             torch.tensor(pay))
    got = (loop if loop is not None else coeff).float().numpy()
    np.testing.assert_allclose(got, co, rtol=1e-6)
    if dtype == "bf16":
        assert np.array_equal(got, co)              # every bit
        assert coeff.dtype == torch.float32 and loop.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="per-BS scale"):
        channel.compress_channel(torch.tensor(snr), "int8")
    with pytest.raises(ValueError, match="unknown channel_dtype"):
        channel.compress_channel(torch.tensor(snr), "f16")


def test_make_problem_hooks_match_jax():
    """Shadowing, the compute stretch, the power deficit and the payload
    through make_problem, as the engine world calls it."""
    jk, tk = _key(4)
    rs = np.random.default_rng(4)
    pos = rs.uniform(0, 1000, (40, 2)).astype(np.float32)
    bs = rs.uniform(0, 1000, (5, 2)).astype(np.float32)
    sh = rs.normal(0, 8, (40, 5)).astype(np.float32)
    tsc = rs.uniform(1, 4, 40).astype(np.float32)
    psc = rs.uniform(0.25, 1, 40).astype(np.float32)
    pay = np.full(40, 0.3, np.float32)
    counts = np.zeros(40, np.float32)
    with jax.threefry_partitionable(True):
        jp = j_channel.make_problem(jk, JMobility(user_pos=pos, bs_pos=bs),
                                    JW, counts, 0, shadow_db=sh,
                                    tcomp_scale=tsc, power_scale=psc,
                                    payload_mbit=pay)
    T = torch.tensor
    tp = channel.make_problem(tk, MobilityState(user_pos=T(pos), bs_pos=T(bs)),
                              W, T(counts), 0, shadow_db=T(sh),
                              tcomp_scale=T(tsc), power_scale=T(psc),
                              payload_mbit=T(pay))
    for f in ("snr", "tcomp", "coeff", "bs_bw"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-5,
                                   err_msg=f)
    assert np.array_equal(tp.necessary.numpy(), np.asarray(jp.necessary))


# ----------------------------------------------- kernel 3, scaled planes --
def _planes(seed, n, m):
    rs = np.random.default_rng(seed)
    v = (10 ** rs.uniform(-1, 4, (n, m))).astype(np.float32)
    v[::3, : m // 2] = v[::3, m // 2: 2 * (m // 2)]   # cross-column ties
    q = rs.integers(-127, 128, (n, m)).astype(np.int8)
    q[::4, 1::2] = q[::4, 0:m - m % 2:2][:, :len(range(1, m, 2))]
    scale = np.repeat(rs.uniform(0.05, 0.5, (m + 1) // 2), 2)[:m]
    return v, q, scale.astype(np.float32)


@pytest.mark.parametrize("n,m", [(1, 1), (50, 8), (1000, 33), (257, 100)])
def test_best_bs_argmax_plain_matches_pallas(n, m):
    """The plain version of kernel 3 against the Pallas kernel in interpret
    mode: float32 with and without a scale, bfloat16 with one, int8 codes
    with their per-BS scale; ties included, indices exact."""
    v, q, scale = _planes(n * m, n, m)
    bf = jnp.asarray(v).astype(jnp.bfloat16)
    tbf = torch.tensor(np.asarray(bf.astype(jnp.float32))).to(torch.bfloat16)
    cases = [(jnp.asarray(v), torch.tensor(v), None),
             (jnp.asarray(v), torch.tensor(v), scale),
             (bf, tbf, scale), (bf, tbf, None),
             (jnp.asarray(q), torch.tensor(q), scale)]
    for j_snr, t_snr, sc in cases:
        want = np.asarray(j_select.best_bs_argmax(
            j_snr, None if sc is None else jnp.asarray(sc), user_block=64))
        got = ks.best_bs_argmax(t_snr, None if sc is None
                                else torch.tensor(sc))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), (t_snr.dtype, sc is None)


@pytest.mark.parametrize("m", [1, 8, 33, 100, 257])
def test_best_bs_plan_vector_shapes(m):
    """Every bf16 / int8 plan is one csrc/select_topk.cu instantiates: a
    power-of-two group of at most a warp, 4 words in flight a lane, 4
    word loads unless the group is one lane, covering a row's words (one
    more than its bytes / 16 when it does not start on 16 bytes)."""
    for dtype, size in ((torch.bfloat16, 2), (torch.int8, 1)):
        lanes, chunks, rows = ks.best_bs_plan(m, dtype)
        words = -(-m * size // 16) + (1 if m * size % 16 else 0)
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        assert chunks * rows == 4 and (lanes == 1 or chunks == 4)
        assert lanes * chunks >= words or lanes == 32
    with pytest.raises(TypeError):
        ks.best_bs_plan(8, torch.float16)


# ------------------------------------------------------------ scenarios --
def test_builtin_scenarios_match_jax_field_by_field():
    assert list(scenario.SCENARIOS) == list(j_scenario.SCENARIOS)
    assert BUILTINS == [s.name for s in j_scenario._BUILTINS]
    jk, tk = _key(2)
    for name in scenario.SCENARIOS:
        t, j = scenario.get_scenario(name), j_scenario.get_scenario(name)
        for f in dataclasses.fields(j_scenario.ScenarioSpec):
            if f.name not in ("faults", "description"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f)
        assert (dataclasses.asdict(t.wireless(W))
                == dataclasses.asdict(j.wireless(JW)))
        with jax.threefry_partitionable(True):
            want = np.asarray(j.sample_bs_bw(jk, j.wireless(JW)))
        assert np.array_equal(t.sample_bs_bw(tk, t.wireless(W)).numpy(),
                              want)


# ------------------------------------------------------------ partition --
@pytest.mark.parametrize("seed", [0, 7, 12])
@pytest.mark.parametrize("alpha", [0.1, 1.0, 100.0])
def test_dirichlet_partition_indices(seed, alpha):
    labels = np.random.default_rng(seed).integers(0, 10, 400).astype(
        np.int32)
    jk, tk = _key(seed)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.jit(lambda k, y: j_dirichlet(
            k, y, 12, 33, alpha, 10))(jk, labels))
    got = dirichlet_partition(tk, torch.tensor(labels), 12, 33, alpha, 10)
    assert got.shape == (12, 33)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="samples_per_user"):
        dirichlet_partition(tk, torch.tensor(labels), 12, 0, alpha, 10)


# ------------------------------------------------ FLConfig and the engine --
@pytest.mark.parametrize("name", BUILTINS)
def test_engine_world_scenario_matches_live_jax(name, monkeypatch,
                                                record_property):
    """FLSimulation(FLConfig(scenario=name)) with dagsa_jit, 2 rounds,
    against a live JAX run (its fused scan) of the engine_sync world."""
    extra = dict(scheduler="dagsa_jit", scenario=name)
    if scenario.get_scenario(name).compress is None:
        check_run_against_live_jax(extra, rounds=2)
        return
    steps = _flip_budget(monkeypatch)
    check_run_against_live_jax(
        extra, rounds=2, params_check=lambda t, j: assert_params_close(
            [t], [j], steps, record_property))


def test_engine_world_speed_and_hetero_bw_match_live_jax():
    """The explicit fields beat the scenario: a speed override and the
    Fig. 3 bandwidth draw, with the host greedy (JAX's eager path)."""
    check_run_against_live_jax(dict(scenario="waypoint", speed_mps=55.0,
                                    hetero_bw=True), mode="eager", rounds=2)


def test_config_resolution_matches_jax():
    w = WirelessConfig(n_users=12, n_bs=4)
    small = dict(n_train=120, n_test=40, local_epochs=1, batch_size=10)
    with pytest.raises(ValueError, match="static"):
        FLSimulation(FLConfig(wireless=w, scenario="static", speed_mps=5.0,
                              **small), device="cpu")
    sim = FLSimulation(FLConfig(wireless=w, scenario="hfl-default",
                                scheduler="dagsa_jit", **small), device="cpu")
    assert (sim.aggregation, sim.tau_global) == ("hierarchical", 5)
    sim = FLSimulation(FLConfig(wireless=w, scenario="hfl-default",
                                scheduler="dagsa_jit", tau_global=2,
                                **small), device="cpu")
    assert sim.tau_global == 2
    with pytest.raises(ValueError, match="tau_global"):
        FLSimulation(FLConfig(wireless=w, scenario="paper-default",
                              tau_global=2, **small), device="cpu")
    sim = FLSimulation(FLConfig(wireless=w, scenario="compressed-uplink",
                                scheduler="dagsa_jit", topk_frac=0.5,
                                **small), device="cpu")
    assert (sim.compress, sim.topk_frac) == ("topk-int8", 0.5)
    with pytest.raises(ValueError, match="topk_frac"):
        FLSimulation(FLConfig(wireless=w, scenario="paper-default",
                              topk_frac=0.5, **small), device="cpu")
    with pytest.raises(ValueError, match="host-side"):
        FLSimulation(FLConfig(wireless=w, scenario="hetero-compute",
                              **small), device="cpu")
    sim = FLSimulation(FLConfig(wireless=w, scenario="non-iid-pathological",
                                scheduler="dagsa_jit", **small),
                       device="cpu")
    assert sim.partition == "dirichlet" and sim.x_clients.shape[1] == 10
    with pytest.raises(ValueError, match="dirichlet_alpha"):
        FLConfig(partition="shard", dirichlet_alpha=0.5)
    with pytest.raises(ValueError, match="unknown scenario"):
        FLConfig(scenario="no-such-world")
    with pytest.raises(ValueError, match="dirichlet_alpha"):
        FLSimulation(FLConfig(wireless=w, partition="dirichlet", **small),
                     device="cpu")
    for cfg in (FLConfig, JConfig):
        with pytest.raises(ValueError, match="dirichlet_alpha"):
            cfg(dirichlet_alpha=-1.0)


@pytest.mark.parametrize("dest", ["speed", "hetero_bw", "scenario",
                                  "partition", "dirichlet_alpha"])
def test_fl_sim_world_flags_default_as_jax(dest, monkeypatch):
    port = _parser_default(fl_sim.main, ([],), dest, monkeypatch)
    ref = _parser_default(j_fl_sim.main, (), dest, monkeypatch)
    assert port == ref


def test_fl_sim_scenario_cli_runs_on_cpu(capsys):
    fl_sim.main(["--device", "cpu", "--rounds", "2", "--n-train", "200",
                 "--n-test", "40", "--batch-size", "4", "--local-epochs",
                 "1", "--scheduler", "rs", "--scenario",
                 "non-iid-pathological", "--speed", "50"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[1:3]] == ["1", "2"]
