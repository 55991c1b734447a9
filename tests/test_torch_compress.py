"""The compressed uplink of the port against the JAX package: the payload
model, the top-k threshold, ``sparsify_quantize`` (kernel 6), the tree
compressor, the decompress-fused FedAvg reductions (kernels 4 and 5 over
int8 codes), and the ``topk-int8`` slice, single-tier and hierarchical,
against live runs.

Tolerances: the payload model, thresholds and codes are exact (the codes
bit for bit against the Pallas kernel in interpret mode); the reductions
rtol=1e-5 (sums in another order).  On the CPU every wrapper runs its plain
version; the CUDA kernels are held against these on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.types import WirelessConfig as JWireless  # noqa: E402
from repro.fl.rounds import FLConfig as JConfig  # noqa: E402
from repro.fl.rounds import FLSimulation as JSimulation  # noqa: E402
from repro.kernels import compress_topk as jct  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.fedavg_reduce import _reduce_leaf as j_reduce  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation  # noqa: E402
from repro_torch.interop import key_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import compress_topk as ct  # noqa: E402
from repro_torch.kernels import fedavg_reduce as kf  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy


def _tree(seed, n, zero_row=None):
    """A client-delta tree {a: {w, b}, f: {w}} with leaves [n, ...]."""
    rs = np.random.default_rng(seed)
    tree = {"a": {"w": rs.normal(size=(n, 3, 3, 1, 4)),
                  "b": rs.normal(size=(n, 4))},
            "f": {"w": rs.normal(size=(n, 40, 7))}}
    tree = {k: {leaf: v.astype(np.float32) for leaf, v in sub.items()}
            for k, sub in tree.items()}
    if zero_row is not None:
        for sub in tree.values():
            for v in sub.values():
                v[zero_row] = 0.0
    return tree


def _to_torch(tree):
    return {k: {leaf: T(np.array(v)) for leaf, v in sub.items()}
            for k, sub in tree.items()}


def _assert_tree(got, want, exact=False, **tol):
    for k in want:
        for leaf in want[k]:
            g = got[k][leaf]
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            w = np.asarray(want[k][leaf])
            if exact:
                assert g.dtype == w.dtype, (k, leaf, g.dtype, w.dtype)
                np.testing.assert_array_equal(g, w, err_msg=f"{k}.{leaf}")
            else:
                np.testing.assert_allclose(g, w, err_msg=f"{k}.{leaf}",
                                           **tol)


@pytest.mark.parametrize("frac", [1.0, 0.5, 0.1, 0.013, 1e-6])
@pytest.mark.parametrize("quantize", [False, True])
def test_payload_model_equals_jax(frac, quantize):
    params = cnn.init(torch.tensor([0, 3]), cnn.CNNConfig.paper_scale())
    np_params = params_to_numpy(params)
    assert ct.payload_bits(params, frac, quantize) == \
        jct.payload_bits(np_params, frac, quantize)
    assert ct.compression_ratio(params, frac, quantize) == \
        jct.compression_ratio(np_params, frac, quantize)
    for d in (1, 7, 100352):
        assert ct.nominal_k(d, frac) == jct.nominal_k(d, frac)


def _rows_with_ties(seed, n, d):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(n, d)).astype(np.float32)
    x[0, : d // 2] = 0.5                       # magnitude ties ...
    x[0, d // 2:] = -0.5                       # ... of both signs
    x[1, 3] = -x[1, 5]                         # a tie inside a normal row
    x[2] = 0.0                                 # an all-zero row
    return x


@pytest.mark.parametrize("n,d,k", [(6, 37, 5), (13, 300, 30), (3, 8, 8),
                                   (5, 129, 1)])
def test_topk_threshold_and_scale_exact(n, d, k):
    x = _rows_with_ties(n * d, n, d)
    jt, jm = jct.topk_threshold(jnp.asarray(x), k)
    tt, tm = ct.topk_threshold(T(x), k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ct.quant_scale(tm).numpy(),
                                  np.asarray(jct.quant_scale(jm)))
    assert ct.quant_scale(tm)[2].item() == 1.0          # all-zero row


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n,d,k", [(6, 37, 5), (13, 700, 70), (40, 130, 13)])
def test_sparsify_quantize_bit_exact_against_pallas(quantize, n, d, k):
    x = _rows_with_ties(d + k, n, d)
    x[3, 4] = np.nan                           # screened to 0 first
    x[4, 1] = -np.inf
    xs = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    thresh, rowmax = jct.topk_threshold(jnp.asarray(xs), k)
    scale = (jct.quant_scale(rowmax) if quantize
             else jnp.ones((n,), jnp.float32))
    u = np.random.default_rng(d).random((n, d)).astype(np.float32)
    want = np.asarray(jct.sparsify_quantize(
        jnp.asarray(x), thresh, scale, jnp.asarray(u), quantize=quantize,
        interpret=True))
    got = ct.sparsify_quantize(T(x), T(np.array(thresh)),
                               T(np.array(scale)),
                               T(u) if quantize else None,
                               quantize=quantize).numpy()
    assert got.dtype == want.dtype == (np.int8 if quantize else np.float32)
    np.testing.assert_array_equal(got.view(np.uint8) if quantize
                                  else got.view(np.uint32),
                                  want.view(np.uint8) if quantize
                                  else want.view(np.uint32))
    # every tie at the threshold survives: row 0 keeps all d entries
    assert (got[0] != 0).all()
    assert (got[2] == 0).all()
    oracle, _ = ref.compress_update(jnp.asarray(x), k, quantize=quantize,
                                    u=jnp.asarray(u))
    np.testing.assert_array_equal(got, np.asarray(oracle))


def test_sparsify_quantize_needs_noise_to_quantize():
    x = torch.ones((2, 3))
    with pytest.raises(ValueError, match="noise"):
        ct.sparsify_quantize(x, torch.ones(2), torch.ones(2), None,
                             quantize=True)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("frac", [0.1, 1.0])
def test_compress_delta_tree_bit_exact(quantize, frac):
    delta = _tree(11, 9, zero_row=4)
    delta["f"]["w"][2, 5, 1] = np.inf          # a non-finite client entry
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(5)
        jc, js = jct.compress_delta_tree(delta, frac, quantize=quantize,
                                         key=key, backend="pallas",
                                         interpret=True)
        jc_oracle, _ = jct.compress_delta_tree(delta, frac,
                                               quantize=quantize, key=key,
                                               backend="jax")
    tc, ts = ct.compress_delta_tree(_to_torch(delta), frac,
                                    quantize=quantize,
                                    key=key_from_numpy(np.asarray(key)))
    _assert_tree(tc, jc, exact=True)
    _assert_tree(tc, jc_oracle, exact=True)
    _assert_tree(ts, js, exact=True)
    _assert_tree(ct.decompress_tree(tc, ts), jct.decompress_tree(jc, js),
                 exact=True)
    np.testing.assert_allclose(
        ct.compressed_clip_scales(tc, ts, 3.0).numpy(),
        np.asarray(jct.compressed_clip_scales(jc, js, 3.0)), rtol=1e-6)
    if quantize:
        with pytest.raises(ValueError, match="PRNG key"):
            ct.compress_delta_tree(_to_torch(delta), frac, quantize=True)


def _codes(seed, n, quantize=True):
    delta = _tree(seed, n, zero_row=1)
    with jax.threefry_partitionable(True):
        codes, scales = jct.compress_delta_tree(
            delta, 0.2, quantize=quantize, key=jax.random.PRNGKey(seed),
            backend="jax")
    return (jax.tree.map(np.asarray, codes), jax.tree.map(np.asarray, scales))


@pytest.mark.parametrize("case", ["plain", "weights", "clip", "empty", "f32"])
def test_fedavg_decompress_reduce_matches_jax(case):
    n = 11
    codes, scales = _codes(3, n, quantize=case != "f32")
    g = {k: {leaf: v[0] * 0.5 for leaf, v in sub.items()}
         for k, sub in _tree(4, 1).items()}
    rs = np.random.default_rng(6)
    sel = rs.random(n) < 0.6
    sel[1] = True                              # the all-zero delta
    sizes = rs.integers(10, 50, n).astype(np.int32)
    kwargs = {}
    if case == "weights":
        kwargs["weights"] = rs.uniform(0.2, 1.0, n).astype(np.float32)
    if case == "clip":
        kwargs["clip_norm"] = 0.5
    if case == "empty":
        sel[:] = False
    want = jct.fedavg_decompress_reduce(g, codes, scales, sel, sizes,
                                        interpret=True, **kwargs)
    oracle = ref.fedavg_decompress_reduce(g, codes, scales, sel, sizes,
                                          **kwargs)
    t_kwargs = {k: (T(v) if isinstance(v, np.ndarray) else v)
                for k, v in kwargs.items()}
    got = ct.fedavg_decompress_reduce(_to_torch(g), _to_torch(codes),
                                      _to_torch(scales), T(sel), T(sizes),
                                      **t_kwargs)
    _assert_tree(got, want, rtol=1e-5, atol=1e-6)
    _assert_tree(got, oracle, rtol=1e-5, atol=1e-6)
    if case == "empty":
        _assert_tree(got, g, exact=True)


@pytest.mark.parametrize("case", ["plain", "clip", "empty_bs", "f32"])
def test_fedavg_decompress_segment_reduce_matches_jax(case):
    n, m = 13, 5
    codes, scales = _codes(8, n, quantize=case != "f32")
    rs = np.random.default_rng(9)
    edge = {k: {leaf: v[:m] for leaf, v in sub.items()}
            for k, sub in _tree(10, m).items()}
    bs = rs.integers(0, m, n)
    assign = np.eye(m, dtype=bool)[bs] & (rs.random(n) < 0.8)[:, None]
    assign[:, 2] = False                       # an empty BS keeps its model
    serving = rs.integers(0, m, n).astype(np.int32)
    sizes = rs.integers(10, 50, n).astype(np.int32)
    kwargs = {"clip_norm": 0.5} if case == "clip" else {}
    if case == "empty_bs":
        assign[:] = False
    want = jct.fedavg_decompress_segment_reduce(
        edge, codes, scales, assign, serving, sizes, interpret=True,
        **kwargs)
    oracle = ref.fedavg_decompress_segment_reduce(edge, codes, scales,
                                                  assign, serving, sizes,
                                                  **kwargs)
    got = ct.fedavg_decompress_segment_reduce(
        _to_torch(edge), _to_torch(codes), _to_torch(scales), T(assign),
        T(serving), T(sizes), **kwargs)
    _assert_tree(got, want, rtol=1e-5, atol=1e-6)
    _assert_tree(got, oracle, rtol=1e-5, atol=1e-6)
    for k in edge:
        for leaf in edge[k]:
            np.testing.assert_array_equal(got[k][leaf][2].numpy(),
                                          edge[k][leaf][2])


@pytest.mark.parametrize("n,d", [(40, 300), (7, 1000), (33, 1)])
def test_int8_reduce_leaf_matches_pallas(n, d):
    rs = np.random.default_rng(n * d)
    x = rs.integers(-127, 128, (n, d)).astype(np.int8)
    w = rs.random(n).astype(np.float32)
    want = np.asarray(j_reduce(jnp.asarray(w).reshape(-1, 1),
                               jnp.asarray(x), 32, 128, True))
    before = dict(_lib.LAUNCHES)
    got = kf.reduce_leaf(T(w), T(x))
    assert _lib.LAUNCHES == before             # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def _flip_budget(monkeypatch):
    """Record each compressed leaf's largest dequant scale per round: one
    int8 step of client i moves the aggregate by scale_i * w_i / sum w,
    which is at most that scale."""
    steps = {}
    orig = ct.compress_delta_tree

    def spy(delta, topk_frac, **kw):
        codes, scales = orig(delta, topk_frac, **kw)
        for path, s in _flat(scales):
            steps[path] = max(steps.get(path, 0.0), float(s.max()))
        return codes, scales

    monkeypatch.setattr(ct, "compress_delta_tree", spy)
    return steps


def _flat(tree):
    return [(f"{k}.{leaf}", tree[k][leaf]) for k in sorted(tree)
            for leaf in sorted(tree[k])]


MAX_FLIPPED = 12


def assert_params_close(got_trees, want_trees, steps, record):
    """rtol=1e-4, atol=1e-5, plus one int8 step on at most MAX_FLIPPED
    entries over all the trees (a code that flipped at a rounding boundary:
    the two packages' SGD differ by ulps).  Returns how many entries needed
    the step."""
    flipped = 0
    for got, want in zip(got_trees, want_trees):
        for path, w in _flat(want):
            k, leaf = path.split(".")
            err = np.abs(got[k][leaf] - w)
            base = 1e-5 + 1e-4 * np.abs(w)
            flipped += int((err > base).sum())
            assert (err <= base + steps.get(path, 0.0)).all(), path
    record("entries_within_one_int8_step", flipped)
    print(f"entries that needed the one-int8-step tolerance: {flipped}")
    assert flipped <= MAX_FLIPPED
    return flipped


@pytest.mark.parametrize("aggregation", ["single", "hierarchical"])
def test_topk_int8_slice_matches_live_jax_run(aggregation, monkeypatch,
                                              record_property):
    """The engine_sync config (12 users, 4 BSs, 120/40 samples, 1 epoch,
    batch 10, seed 7, dagsa_jit) with ``compress="topk-int8",
    topk_frac=0.1``, single-tier and hierarchical (``tau_global=2``), 3
    rounds against JAX in ``mode="step"``: decisions and ``handover_rate``
    exact; ``t_round`` (payload-scaled) and ``wall_clock`` rtol=1e-5;
    ``test_acc`` within one of the 40 samples; global (and edge)
    parameters rtol=1e-4, atol=1e-5 plus one int8 step on at most
    ``MAX_FLIPPED`` entries (see :func:`assert_params_close`)."""
    base = dict(n_train=120, n_test=40, local_epochs=1, batch_size=10,
                eval_every=1, seed=7, scheduler="dagsa_jit",
                compress="topk-int8", topk_frac=0.1)
    if aggregation == "hierarchical":
        base.update(aggregation="hierarchical", tau_global=2)
    with jax.threefry_partitionable(True):
        jsim = JSimulation(JConfig(wireless=JWireless(n_users=12, n_bs=4),
                                   **base))
        want = jsim.run(3, mode="step")
        j_params = jax.tree.map(np.asarray, jsim.params)
        j_edge = (jax.tree.map(np.asarray, jsim.edge_params)
                  if aggregation == "hierarchical" else None)
    steps = _flip_budget(monkeypatch)
    tsim = FLSimulation(FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4),
                                 **base), device="cpu")
    got = tsim.run(3)
    for g, w in zip(got, want):
        assert (g.n_selected, g.min_part_rate) == (w.n_selected,
                                                   w.min_part_rate)
        np.testing.assert_array_equal(g.handover_rate, w.handover_rate)
        np.testing.assert_allclose(g.t_round, w.t_round, rtol=1e-5)
        np.testing.assert_allclose(g.wall_clock, w.wall_clock, rtol=1e-5)
        assert abs(g.test_acc - w.test_acc) <= 1.0 / 40 + 1e-7
    got_trees = [params_to_numpy(tsim.params)]
    want_trees = [j_params]
    if j_edge is not None:
        got_trees.append(params_to_numpy(tsim.edge_params))
        want_trees.append(j_edge)
    assert_params_close(got_trees, want_trees, steps, record_property)
