"""repro_torch.launch.sweep against a live run of repro.launch.sweep.

The wireless sweep over every registered scenario in each channel storage
type (f32, bf16, int8 dB codes + per-BS scale), and the learning sweep in
the device-spread world and over the bf16 plane under faults, with the
arguments of the four sweep cases of tests/test_golden_trajectories.py
(12 users, 4 BSs, 2 seeds, 3 rounds, 120 / 40 samples, 1 local epoch,
batch 10, seed 7; those cases themselves: test_torch_sweep_golden.py).  ``n_selected`` exact; ``t_round``, ``wall_clock``,
``min_part_rate``, ``participants_mean`` and the delivery records rtol
1e-5; ``test_acc`` within one of the 40 test samples (a sample whose two
top logits tie within float32 rounding can take either class).  The JAX
package runs each bucket as one jitted call; XLA's rounding points in it
are the ones the port reproduces (ROADMAP C.3, C.10).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.launch import sweep as j_sweep  # noqa: E402
from repro_torch.core import scenario  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402

from test_torch_slice import _parser_default, cap_torch_threads  # noqa: E402

cap_torch_threads()

NAMES = list(scenario.SCENARIOS)          # the built-ins and faulty worlds
TINY = dict(n_seeds=2, n_rounds=3, seed=7)
LEARN = dict(n_seeds=2, n_rounds=3, n_train=120, n_test=40, local_epochs=1,
             batch_size=10, eval_every=1, seed=7)
GOLDEN = {
    "sweep_sync": (["paper-default", "high-mobility"], {}),
    "sweep_hier": (["paper-default"], dict(aggregation="hierarchical",
                                           tau_global=2)),
    "sweep_faulty": (["faulty-uplink"], dict(scheduler="dagsa-r")),
    "sweep_faulty_async": (["faulty-uplink"],
                           dict(scheduler="dagsa-r", aggregation_async=True,
                                tick_s=0.5, staleness_alpha=0.5)),
}


@pytest.fixture(scope="module", params=["f32", "bf16", "int8"])
def wireless(request):
    dt = request.param
    with jax.threefry_partitionable(True):
        want = j_sweep.run_sweep(NAMES, cfg=JWireless(n_users=12, n_bs=4),
                                 channel_dtype=dt, **TINY)
    got = sweep.run_sweep(NAMES, cfg=WirelessConfig(n_users=12, n_bs=4),
                          channel_dtype=dt, device="cpu", **TINY)
    return dt, want, got


def test_wireless_sweep_matches_live_jax(wireless):
    dt, want, got = wireless
    assert [r["scenario"] for r in got] == NAMES
    _check_wireless(want, got, dt)


def _check_wireless(want, got, dt):
    """The wireless records against JAX's: decisions exact, latencies and
    participation rtol 1e-5 (``dt`` labels a failure)."""
    for w, g in zip(want, got):
        assert set(g) == set(w) and set(g["curves"]) == set(w["curves"])
        for k in ("scenario", "mobility", "speed_mps", "n_seeds",
                  "n_rounds"):
            assert g[k] == w[k], (dt, w["scenario"], k)
        assert g["curves"]["n_selected"] == w["curves"]["n_selected"], \
            (dt, w["scenario"])
        for k in ("t_round_mean_s", "t_round_p95_s", "participants_mean",
                  "min_part_rate"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"{dt} {w['scenario']} {k}")
        for k in ("t_round_s", "min_part_rate"):
            np.testing.assert_allclose(g["curves"][k], w["curves"][k],
                                       rtol=1e-5,
                                       err_msg=f"{dt} {w['scenario']} {k}")


def _check_learning(want, got):
    for w, g in zip(want, got):
        name = w["scenario"]
        assert set(g) == set(w), (name, set(g) ^ set(w))
        assert set(g["curves"]) == set(w["curves"])
        for k in ("scenario", "aggregation", "tau_global", "scheduler",
                  "faults", "n_seeds", "n_rounds", "partition",
                  "dirichlet_alpha", "compress", "topk_frac",
                  "aggregation_async", "tick_s", "staleness_alpha",
                  "buffer_size"):
            assert g.get(k) == w.get(k), (name, k)
        assert g["curves"]["n_selected"] == w["curves"]["n_selected"], name
        np.testing.assert_allclose(g["seed_curves"]["wall_clock_s"],
                                   w["seed_curves"]["wall_clock_s"],
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(g["curves"]["t_round_s"],
                                   w["curves"]["t_round_s"], rtol=1e-5,
                                   err_msg=name)
        ga = np.asarray(g["seed_curves"]["test_acc"], np.float64)
        wa = np.asarray(w["seed_curves"]["test_acc"], np.float64)
        assert np.array_equal(np.isnan(ga), np.isnan(wa))
        assert np.nanmax(np.abs(ga - wa)) <= 1.0 / 40 + 1e-7, name
        for k in ("n_delivered", "delivered_rate", "goodput_mbit_s",
                  "n_inflight", "n_dropped", "handover_rate"):
            if k in w["curves"]:
                np.testing.assert_allclose(g["curves"][k], w["curves"][k],
                                           rtol=1e-5, err_msg=f"{name} {k}")
        for k in ("uplink_compression_ratio", "uplink_mbit_per_client"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6)


@pytest.mark.parametrize("names,kw", [
    (["hetero-compute"], {}),
    (["faulty-uplink"], dict(channel_dtype="bf16", scheduler="dagsa-r")),
])
def test_learning_worlds_match_live_jax(names, kw):
    """The device spreads in the sweep world; the bf16 channel plane under
    the fault layer, whose per-user latency reads the bf16-rounded
    coefficients while the greedy's outer solves read the float32 ones
    (ROADMAP C.10).  The Dirichlet partition's per-seed inputs:
    test_learning_seed_inputs_match_jax."""
    with jax.threefry_partitionable(True):
        want = j_sweep.run_learning_sweep(
            names, cfg=JWireless(n_users=12, n_bs=4), **LEARN, **kw)
    got = sweep.run_learning_sweep(
        names, cfg=WirelessConfig(n_users=12, n_bs=4), device="cpu",
        **LEARN, **kw)
    _check_learning(want, got)


def test_scenario_params_match_jax():
    specs = [scenario.get_scenario(n) for n in NAMES]
    from repro.core.scenario import get_scenario as j_get
    jp = j_sweep._scenario_params([j_get(n) for n in NAMES],
                                  JWireless(n_users=12, n_bs=4))
    tp = sweep._scenario_params(specs, WirelessConfig(n_users=12, n_bs=4))
    assert list(tp) == list(jp)
    for k in jp:
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k


def test_learning_seed_inputs_match_jax():
    """Each seed's partition and CNN init, as JAX vmaps them over seeds."""
    from repro.data import make_dataset as j_data
    from repro.models import cnn as j_cnn
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.interop import key_from_numpy, params_to_numpy
    from repro_torch.models import cnn

    with jax.threefry_partitionable(True):
        jd = j_data("mnist", seed=3, n_train=240, n_test=40)
        kp, ki = jax.random.split(jax.random.PRNGKey(3))
        for part, alpha in (("dirichlet", 0.3),):
            jx, jy, jw = j_sweep._learning_seed_inputs(
                jd, j_cnn.CNNConfig(height=28, width=28, channels=1), kp, ki,
                3, 12, 2, partition=part, dirichlet_alpha=alpha)
            td = make_dataset("mnist", seed=3, n_train=240, n_test=40)
            tx, ty, tw = sweep._learning_seed_inputs(
                td, cnn.CNNConfig(height=28, width=28, channels=1),
                key_from_numpy(np.asarray(kp)), key_from_numpy(np.asarray(ki)),
                3, 12, 2, partition=part, dirichlet_alpha=alpha)
            # the indices pick the same samples (labels exact); samples
            # and weights are normal draws, an ulp apart (ROADMAP C.4)
            for s in range(3):
                assert np.array_equal(ty[s].numpy(), np.asarray(jy[s]))
                np.testing.assert_allclose(tx[s].numpy(), np.asarray(jx[s]),
                                           rtol=1e-5, atol=1e-5)
                pw = params_to_numpy(tw[s])
                for k in pw:
                    for leaf in pw[k]:
                        np.testing.assert_allclose(
                            pw[k][leaf], np.asarray(jw[k][leaf][s]),
                            rtol=1e-5, atol=1e-6)


def test_what_the_port_lacks_raises_with_its_label(capsys):
    w = WirelessConfig(n_users=12, n_bs=4)
    # user_chunk is ported: it is validated as in the JAX package
    with pytest.raises(ValueError, match="user_chunk must be >= 1"):
        sweep.run_sweep(["paper-default"], cfg=w, user_chunk=0,
                        device="cpu")
    with pytest.raises(ValueError, match="user_chunk must be >= 1"):
        sweep.main(["--user-chunk", "0", "--device", "cpu"])
    # compute="selected" is ported (test_torch_selected.py); an unknown
    # mode raises
    with pytest.raises(ValueError, match="unknown compute mode"):
        sweep.run_learning_sweep(["paper-default"], cfg=w, compute="sparse",
                                 device="cpu")
    # the stateful policies are sweep schedulers (run in test_torch_state)
    for name in ("ucb", "biased-adaptive", "rr", "pf"):
        assert name in sweep.SWEEP_SCHEDULERS
    # --shard / --mesh are ported (test_torch_shard.py): --mesh alone is
    # the argparse error, and --shard on a world of one prints the
    # unsharded JSON
    with pytest.raises(SystemExit):
        sweep.main(["--mesh", "2", "--device", "cpu"])
    assert "--mesh only applies with --shard" in capsys.readouterr().err
    small = ["--device", "cpu", "--scenarios", "paper-default", "--seeds",
             "1", "--rounds", "1", "--n-users", "12"]
    sweep.main(small)
    plain = capsys.readouterr().out
    sweep.main(small + ["--shard"])
    assert capsys.readouterr().out == plain
    with pytest.raises(ValueError, match="unknown sweep scheduler"):
        sweep.run_learning_sweep(["paper-default"], scheduler="greedy",
                                 device="cpu")
    with pytest.raises(ValueError, match="tick_s"):
        sweep.run_learning_sweep(["paper-default"], cfg=w,
                                 staleness_alpha=0.5, device="cpu")


def test_sweep_runs_on_cuda_by_default_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_sweep(["paper-default"], n_seeds=1, n_rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_learning_sweep(["paper-default"], n_seeds=1, n_rounds=1)


@pytest.mark.parametrize("dest", ["scenarios", "seeds", "rounds", "seed",
                                  "channel_dtype", "n_train", "n_test",
                                  "local_epochs", "batch_size", "lr",
                                  "scheduler", "partition",
                                  "dirichlet_alpha", "compress"])
def test_cli_defaults_are_the_references(dest, monkeypatch):
    port = _parser_default(sweep.main, ([],), dest, monkeypatch)
    ref = _parser_default(j_sweep.main, (), dest, monkeypatch)
    assert port == ref


def test_cli_writes_records_on_cpu(tmp_path):
    import json

    out = tmp_path / "wireless.json"
    sweep.main(["--device", "cpu", "--scenarios", "paper-default,static",
                "--seeds", "1", "--rounds", "2", "--n-users", "12",
                "--channel-dtype", "int8", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [r["scenario"] for r in recs] == ["paper-default", "static"]
    out = tmp_path / "learning.json"
    sweep.main(["--device", "cpu", "--learning", "--scenarios",
                "paper-default", "--seeds", "1", "--rounds", "2",
                "--n-users", "12", "--n-train", "120", "--n-test", "40",
                "--local-epochs", "1", "--out", str(out)])
    (rec,) = json.loads(out.read_text())
    assert len(rec["curves"]["test_acc"]) == 2
