"""Hierarchical (per-BS edge) FL in the port against the JAX package: the
segmented Eq. (2) (plain and kernel 5's wrapper, float32 and int8), the
global sync, the serving cell, per-client local SGD, the ``engine_hier``
slice against a live run, the config guards and the CLI.

Tolerances: indices, weights and decisions exact; reductions rtol=1e-5
(sums in another order); local SGD rtol=1e-4 (rounding carried through
chained updates); the slice as in test_torch_slice.py.  On the CPU the
kernel wrappers run their plain versions; the CUDA kernels are held
against these on the card (tests/test_torch_cuda.py, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.fl import server as j_server  # noqa: E402
from repro.fl.rounds import FLConfig as JConfig  # noqa: E402
from repro.fl.rounds import FLSimulation as JSimulation  # noqa: E402
from repro.fl.rounds import camped_bs as j_camped_bs  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.fedavg_reduce import \
    _segment_reduce_leaf as j_segment_leaf  # noqa: E402
from repro.kernels.fedavg_reduce import \
    fedavg_segment_reduce as j_segment  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl import client, server  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation, camped_bs  # noqa: E402
from repro_torch.interop import (key_from_numpy, params_from_numpy,  # noqa: E402
                                 params_to_numpy)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import fedavg_reduce as kf  # noqa: E402
from repro_torch.launch import fl_sim  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy


def _fleet(seed, n, m):
    rs = np.random.default_rng(seed)
    shapes = {"a": {"w": (3, 3, 1, 4), "b": (4,)}, "f": {"w": (20, 7)}}
    edge = {k: {leaf: rs.normal(size=(m,) + s).astype(np.float32)
                for leaf, s in sub.items()} for k, sub in shapes.items()}
    clients = {k: {leaf: rs.normal(size=(n,) + s).astype(np.float32)
                   for leaf, s in sub.items()} for k, sub in shapes.items()}
    bs = rs.integers(0, m, n)
    assign = np.eye(m, dtype=bool)[bs] & (rs.random(n) < 0.8)[:, None]
    sizes = rs.integers(10, 50, n).astype(np.int32)
    return edge, clients, assign, sizes


def _to_torch(tree):
    return {k: {leaf: T(np.array(v)) for leaf, v in sub.items()}
            for k, sub in tree.items()}


def _assert_tree(got, want, **tol):
    for k in want:
        for leaf in want[k]:
            np.testing.assert_allclose(got[k][leaf].numpy(),
                                       np.asarray(want[k][leaf]),
                                       err_msg=f"{k}.{leaf}", **tol)


@pytest.mark.parametrize("case", ["plain", "poisoned", "clip", "empty_bs",
                                  "nobody"])
def test_segmented_fedavg_matches_pallas_and_oracle(case):
    n, m = 13, 5                                 # 13 is not a multiple of 8
    edge, clients, assign, sizes = _fleet(1, n, m)
    assign[:, 3] = False                         # an empty BS
    kwargs = {"clip_norm": 2.5} if case == "clip" else {}
    if case == "poisoned":
        assign[2] = np.eye(m, dtype=bool)[0]
        clients["a"]["w"][2, 0, 0, 0, 1] = np.nan
        clients["f"]["w"][6, 3, 3] = np.inf
    if case == "nobody":
        assign[:] = False
    want = j_segment(edge, clients, assign, sizes, client_block=8,
                     feature_block=128, interpret=True, **kwargs)
    oracle = ref.fedavg_segment_reduce(edge, clients, assign, sizes,
                                       **kwargs)
    te, tc = _to_torch(edge), _to_torch(clients)
    before = dict(_lib.LAUNCHES)
    got = kf.fedavg_segment_reduce(te, tc, T(assign), T(sizes), **kwargs)
    plain = server.fedavg_segmented(te, tc, T(assign), T(sizes), **kwargs)
    assert _lib.LAUNCHES == before               # CPU tensors launch nothing
    for tree in (got, plain):
        _assert_tree(tree, want, rtol=1e-5, atol=1e-6)
        _assert_tree(tree, oracle, rtol=1e-5, atol=1e-6)
        for k in edge:
            for leaf in edge[k]:
                out = tree[k][leaf].numpy()
                assert np.isfinite(out).all()
                np.testing.assert_array_equal(out[3], edge[k][leaf][3])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("n,m,d", [(13, 5, 300), (40, 8, 129), (3, 17, 7)])
def test_segment_reduce_leaf_matches_pallas(dtype, n, m, d):
    rs = np.random.default_rng(n * m + d)
    if dtype == "int8":
        x = rs.integers(-127, 128, (n, d)).astype(np.int8)
        cb = 32
    else:
        x = rs.normal(size=(n, d)).astype(np.float32)
        x[1, 2], x[n - 1, 0] = np.nan, -np.inf
        cb = 8
    w = (rs.random((n, m)) * (rs.random((n, m)) < 0.5)).astype(np.float32)
    w[:, m // 2] = 0.0                           # an empty BS column
    want = np.asarray(j_segment_leaf(jnp.asarray(w), jnp.asarray(x), cb, 128,
                                     True))
    got = kf.segment_reduce_leaf(T(w), T(x)).numpy()
    assert got.shape == (m, d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got[m // 2] == 0.0).all()


def test_segment_reduce_leaf_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float32 or int8"):
        kf._x_kind(torch.zeros((2, 3), dtype=torch.float64))


@pytest.mark.parametrize("weights", [[3.0, 0.0, 1.5, 2.0], [0.0] * 4])
def test_edge_global_sync_and_segment_weights_match_jax(weights):
    edge, clients, assign, sizes = _fleet(2, 9, 4)
    g = {k: {leaf: v[0] for leaf, v in sub.items()}
         for k, sub in edge.items()}
    w = np.asarray(weights, np.float32)
    want = j_server.edge_global_sync(g, edge, jnp.asarray(w))
    got = server.edge_global_sync(_to_torch(g), _to_torch(edge), T(w))
    _assert_tree(got, want, rtol=1e-6, atol=1e-7)
    jw, jt = j_server.segment_weights(assign, sizes)
    tw, tt = server.segment_weights(T(assign), T(sizes))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_camped_bs_matches_jax():
    rs = np.random.default_rng(4)
    dist = rs.uniform(1, 900, (60, 8)).astype(np.float32)
    dist[5, 3] = dist[5, 6] = dist[5].min()      # a tie: lowest index wins
    got = camped_bs(T(dist))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_camped_bs(jnp.asarray(dist))))
    assert got[5].item() == 3


def test_per_client_local_sgd_matches_jax():
    rs = np.random.default_rng(7)
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(7)
        edge = jax.tree.map(np.asarray, j_cnn.init(key, j_cnn.CNNConfig(
            c1=4, c2=8, hidden=16)))
        edge = jax.tree.map(lambda p: np.stack([p, 0.9 * p, 1.1 * p]), edge)
        serving = np.array([2, 0, 0, 1], np.int32)
        x_all = rs.normal(size=(4, 24, 28, 28, 1)).astype(np.float32)
        y_all = rs.integers(0, 10, (4, 24)).astype(np.int32)
        keys = jax.random.split(key, 4)
        init = j_client.gather_client_tree(edge, jnp.asarray(serving))
        want = j_client.fleet_local_sgd_per_client(
            j_cnn.loss_fn, init, x_all, y_all, keys, epochs=1,
            batch_size=8, lr=0.05)
    t_init = client.gather_client_tree(params_from_numpy(edge), T(serving))
    _assert_tree(t_init, init, rtol=0, atol=0)
    got = client.fleet_local_sgd_per_client(
        t_init, T(x_all), T(y_all), key_from_numpy(np.asarray(keys)),
        epochs=1, batch_size=8, lr=0.05)
    _assert_tree(got, jax.tree.map(np.asarray, want), rtol=1e-4, atol=1e-6)
    # one global model broadcast into every client is fleet_local_sgd
    g = params_from_numpy(jax.tree.map(lambda p: p[0], edge))
    same = client.fleet_local_sgd(g, T(x_all), T(y_all),
                                  key_from_numpy(np.asarray(keys)), 1, 8,
                                  0.05)
    per = client.fleet_local_sgd_per_client(
        client.gather_client_tree(params_from_numpy(edge),
                                  torch.zeros(4, dtype=torch.int32)),
        T(x_all), T(y_all), key_from_numpy(np.asarray(keys)), 1, 8, 0.05)
    for k in same:
        for leaf in same[k]:
            assert torch.equal(same[k][leaf], per[k][leaf])


ENGINE_HIER = dict(n_train=120, n_test=40, local_epochs=1, batch_size=10,
                   eval_every=1, seed=7, scheduler="dagsa_jit",
                   aggregation="hierarchical", tau_global=2)


def test_engine_hier_slice_matches_live_jax_run():
    """``engine_hier`` (12 users, 4 BSs, 120/40 samples, 1 epoch, batch 10,
    seed 7, dagsa_jit, tau_global=2), 3 rounds against JAX in
    ``mode="step"``: decisions and ``handover_rate`` exact (round 3 hands
    over one user of twelve); ``t_round`` and ``wall_clock`` rtol=1e-5;
    global and edge parameters rtol=1e-4, atol=1e-5; ``test_acc`` within
    one of the 40 test samples."""
    with jax.threefry_partitionable(True):
        jsim = JSimulation(JConfig(wireless=JWireless(n_users=12, n_bs=4),
                                   **ENGINE_HIER))
        want = jsim.run(3, mode="step")
        j_params = jax.tree.map(np.asarray, jsim.params)
        j_edge = jax.tree.map(np.asarray, jsim.edge_params)
        j_edge_w = np.asarray(jsim.edge_weight)
    tsim = FLSimulation(FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4),
                                 **ENGINE_HIER), device="cpu")
    got = tsim.run(3)
    assert [r.round_idx for r in got] == [1, 2, 3]
    for g, w in zip(got, want):
        assert (g.n_selected, g.min_part_rate) == (w.n_selected,
                                                   w.min_part_rate)
        assert g.handover_rate == w.handover_rate
        np.testing.assert_allclose(g.t_round, w.t_round, rtol=1e-5)
        np.testing.assert_allclose(g.wall_clock, w.wall_clock, rtol=1e-5)
        assert abs(g.test_acc - w.test_acc) <= 1.0 / 40 + 1e-7
    assert got[2].handover_rate == pytest.approx(1 / 12)
    _assert_tree(tsim.params, j_params, rtol=1e-4, atol=1e-5)
    _assert_tree(tsim.edge_params, j_edge, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tsim.edge_weight.numpy(), j_edge_w)


def test_hierarchical_sync_collapses_edges_and_tau1_resumes():
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4),
                   **{**ENGINE_HIER, "tau_global": 1})
    sim = FLSimulation(cfg, device="cpu")
    recs = sim.run(1) + sim.run(1)
    assert sim.edge_weight.sum().item() == 0.0
    for k, sub in params_to_numpy(sim.edge_params).items():
        for leaf, e in sub.items():
            for row in e:
                np.testing.assert_array_equal(
                    row, params_to_numpy(sim.params)[k][leaf])
    assert np.isfinite([r.handover_rate for r in recs]).all()
    single = FLSimulation(FLConfig(wireless=WirelessConfig(n_users=12,
                                                           n_bs=4),
                                   n_train=120, n_test=40, local_epochs=1,
                                   batch_size=10, seed=7), device="cpu")
    assert single.edge_params is None
    assert np.isnan(single.run(1)[0].handover_rate)


@pytest.mark.parametrize("kwargs,match", [
    (dict(aggregation="tree"), "unknown aggregation"),
    (dict(aggregation="hierarchical", tau_global=0), "tau_global must be"),
    (dict(tau_global=3), "only applies to aggregation='hierarchical'"),
    (dict(compress="gzip"), "unknown compress mode"),
    (dict(compress="topk", topk_frac=0.0), r"topk_frac must be in \(0, 1\]"),
    (dict(compress="topk", topk_frac=1.5), r"topk_frac must be in \(0, 1\]"),
    (dict(topk_frac=0.1), "only applies with a compress mode"),
])
def test_config_guards_mirror_jax(kwargs, match):
    jkw = dict(wireless=JWireless(n_users=12, n_bs=4), scheduler="dagsa_jit",
               n_train=120, n_test=40, **kwargs)
    with pytest.raises(ValueError, match=match):
        JSimulation(JConfig(**jkw))
    with pytest.raises(ValueError, match=match):
        FLSimulation(FLConfig(**{**jkw, "wireless": WirelessConfig(
            n_users=12, n_bs=4)}), device="cpu")


def test_default_tau_global_is_five():
    sim = FLSimulation(FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4),
                                n_train=120, n_test=40, local_epochs=1,
                                batch_size=10, aggregation="hierarchical"),
                       device="cpu")
    assert sim.tau_global == 5


def test_cli_runs_hierarchical_compressed_on_cpu(capsys):
    # a tensor-step scheduler: as in JAX, the host greedy's eager path has
    # no hierarchical aggregation or compressed uplink
    fl_sim.main(["--device", "cpu", "--scheduler", "dagsa_jit", "--rounds",
                 "2", "--n-train", "200", "--n-test", "40", "--batch-size",
                 "4", "--local-epochs", "1", "--aggregation", "hierarchical",
                 "--tau-global", "2", "--compress", "topk-int8",
                 "--topk-frac", "0.1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["round", "t_round", "clock", "users", "acc",
                                "min_fair", "handover"]
    assert [ln.split()[0] for ln in lines[1:3]] == ["1", "2"]
    assert all(0.0 <= float(ln.split()[-1]) <= 1.0 for ln in lines[1:3])
    assert lines[4].startswith("acc@") and len(lines) == 5
